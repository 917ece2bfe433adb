"""The port's DBN (Dance-Beat Navigator) against the JAX package's, on the
CPU: the network at b = 1 and b = 3 (its LSTM recurs over the batch axis,
and a batch_first LSTM does not match), the weight maps both ways and a
reference-layout checkpoint, the autoregressive rollout, the Kalman filter
(chunked equal to batch bit for bit), the streamer and the trajectory
post-processing.

A small config (window 8, step 4, 2 blocks of 2 x 16, 24 music channels),
f32, the JAX params perturbed so that every leaf shows. Tolerances: one
window 1e-5, the rollout 1e-4 (it feeds its output back), the Kalman
filter 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import TrajDecoderConfig as JaxTrajConfig  # noqa: E402
from tcdiff_tpu.interop.torch_convert import traj_decoder_params_from_torch  # noqa: E402
from tcdiff_tpu.trajdecoder import kalman as jax_kalman  # noqa: E402
from tcdiff_tpu.trajdecoder import postprocess as jax_post  # noqa: E402
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder  # noqa: E402
from tcdiff_tpu.trajdecoder.rollout import autoregressive_rollout as jax_rollout  # noqa: E402
from tcdiff_tpu.trajdecoder.streaming import TrajectoryStreamer as JaxStreamer  # noqa: E402
from tcdiff_torch.config import TrajDecoderConfig  # noqa: E402
from tcdiff_torch.interop.from_jax import (  # noqa: E402
    load_jax_traj_params, load_reference_traj, traj_params_to_state_dict,
)
from tcdiff_torch.trajdecoder import model as model_mod  # noqa: E402
from tcdiff_torch.trajdecoder import postprocess  # noqa: E402
from tcdiff_torch.trajdecoder.kalman import kalman_filter_chunk, kalman_smooth_batch  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.trajdecoder.rollout import autoregressive_rollout  # noqa: E402
from tcdiff_torch.trajdecoder.streaming import TrajectoryStreamer  # noqa: E402

SMALL = dict(window_size=8, step=4, trans_layer=2, latent_dim=16, n_head=2, cond_feature_dim=24)
CFG, JCFG = TrajDecoderConfig(**SMALL), JaxTrajConfig(**SMALL)
W, S, DN = CFG.window_size, CFG.step, 3
MUSIC_WIN = (W + S) * 2


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(TrajDecoderConfig()) == dataclasses.asdict(JaxTrajConfig())


@pytest.fixture(scope="module")
def models():
    jm = JaxTrajDecoder(JCFG)
    params = jm.init(jax.random.key(0), jnp.zeros((1, DN, W, 2)), jnp.zeros((1, MUSIC_WIN, CFG.cond_feature_dim)))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                          params["params"])
    return jm, params, load_jax_traj_params(TrajDecoder(CFG, device="cpu"), params)


def _inputs(b: int, music_len: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.normal(size=(b, DN, W, 2))).astype(np.float32)
    music = rng.normal(size=(b, music_len, CFG.cond_feature_dim)).astype(np.float32)
    return x, music


def _jax_apply(models, x, music):
    jm, params, _ = models
    return np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(music)))


@pytest.mark.parametrize("b", [1, 3])
def test_forward_matches_jax(models, b):
    x, music = _inputs(b, MUSIC_WIN + 1, seed=b)  # an odd music length: the last frame is dropped
    out = models[2](torch.from_numpy(x), torch.from_numpy(music))
    assert out.shape == (b, DN, W, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_apply(models, x, music), atol=1e-5, rtol=1e-5)


def test_lstm_recurs_over_the_batch_axis(models, monkeypatch):
    """At b = 3 the reference's LSTM (no batch_first) recurs over the batch:
    nn.LSTM run that way matches the JAX network, and nn.LSTM with
    batch_first=True (recurring over the tokens) does not."""
    x, music = _inputs(3, MUSIC_WIN, seed=4)
    ref = _jax_apply(models, x, music)
    tmodel = models[2]
    as_built = lambda lstm, xs: torch.nn.LSTM.forward(lstm, xs)[0]
    monkeypatch.setattr(model_mod, "_lstm", as_built)
    np.testing.assert_allclose(tmodel(torch.from_numpy(x), torch.from_numpy(music)).numpy(), ref,
                               atol=1e-5, rtol=1e-5)

    def batch_first(lstm, xs):
        lstm.batch_first = True
        try:
            return torch.nn.LSTM.forward(lstm, xs)[0]
        finally:
            lstm.batch_first = False

    monkeypatch.setattr(model_mod, "_lstm", batch_first)
    err = np.abs(tmodel(torch.from_numpy(x), torch.from_numpy(music)).numpy() - ref).max()
    assert err > 1e-2, f"a batch_first LSTM matched the batch-axis recurrence ({err})"


def test_f32_math_restores_the_callers_flags():
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (mm.allow_tf32, cudnn.allow_tf32)
    try:
        mm.allow_tf32, cudnn.allow_tf32 = True, False
        with model_mod.f32_math():
            assert (mm.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (mm.allow_tf32, cudnn.allow_tf32) == (True, False)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = was


def test_weight_maps_round_trip(models):
    """flax -> the reference's names -> load_state_dict(strict=True) -> the
    JAX package's own torch -> flax map gives the tree back exactly."""
    _, params, tmodel = models
    sd = traj_params_to_state_dict(params, CFG.trans_layer)
    assert set(sd) == set(tmodel.state_dict())
    back = traj_decoder_params_from_torch({k: v.numpy() for k, v in tmodel.state_dict().items()},
                                          CFG.trans_layer)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_loads(models, tmp_path):
    """A reference-layout {'net': state_dict} file, with a buffer the port
    does not hold; a missing parameter raises."""
    _, _, tmodel = models
    sd = dict(tmodel.state_dict())
    sd["trans_extractor.blocks.0.attn.mask"] = torch.ones(1, 1, 4, 4)
    path = tmp_path / "dbn.pt"
    torch.save({"net": sd}, path)
    fresh = load_reference_traj(TrajDecoder(CFG, device="cpu"), str(path))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    del sd["Decoder.6.bias"]
    torch.save({"net": sd}, path)
    with pytest.raises(RuntimeError, match="Decoder.6.bias"):
        load_reference_traj(TrajDecoder(CFG, device="cpu"), str(path))


def test_rollout_matches_jax(models):
    """b = 2 over 7 windows (a music length one short of an 8th); the
    error is printed per window, since the rollout feeds its output back."""
    jm, params, tmodel = models
    x, music = _inputs(2, MUSIC_WIN + 7 * 2 * S - 1, seed=5)
    ref = np.asarray(jax_rollout(jm, params, jnp.asarray(x), jnp.asarray(music), W, S))
    out = autoregressive_rollout(tmodel, torch.from_numpy(x), torch.from_numpy(music), W, S).numpy()
    assert out.shape == ref.shape == (2, DN, W + 7 * S, 2)
    errs = [float(np.abs(out[:, :, W + i * S:W + (i + 1) * S] - ref[:, :, W + i * S:W + (i + 1) * S]).max())
            for i in range(7)]
    print("rollout max |port - jax| by window:", " ".join(f"{e:.1e}" for e in errs))
    np.testing.assert_array_equal(out[:, :, :W], x)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    # no window: the seed comes back as it is
    short = autoregressive_rollout(tmodel, torch.from_numpy(x), torch.from_numpy(music[:, :MUSIC_WIN - 1]), W, S)
    assert torch.equal(short, torch.from_numpy(x))


def _walk(seed: int, shape=(3, 2, 40, 2)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32).cumsum(axis=2)


def test_kalman_matches_jax_and_chunks_equal_batch():
    xy = _walk(0)
    ours = kalman_smooth_batch(torch.from_numpy(xy))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_kalman.kalman_smooth_batch(xy)), atol=1e-5, rtol=1e-5)
    flat, state, outs = torch.from_numpy(xy.reshape(6, 40, 2)), None, []
    for lo, hi in ((0, 7), (7, 8), (8, 25), (25, 40)):  # ragged chunks
        out, state = kalman_filter_chunk(flat[:, lo:hi], state)
        outs.append(out)
    assert torch.equal(torch.cat(outs, dim=1).reshape(xy.shape), ours)
    # the carried state, against the JAX package's after the same chunks
    jstate = None
    for lo, hi in ((0, 7), (7, 8), (8, 25), (25, 40)):
        _, jstate = jax_kalman.kalman_filter_chunk(jnp.asarray(xy.reshape(6, 40, 2)[:, lo:hi]), jstate)
    for a, b in zip(state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_streamer_matches_jax_and_the_full_rollout(models):
    jm, params, tmodel = models
    x, music = _inputs(1, 130, seed=6)
    full = kalman_smooth_batch(autoregressive_rollout(tmodel, torch.from_numpy(x), torch.from_numpy(music), W, S))
    ours = TrajectoryStreamer(tmodel, x, music, W, S)
    ref = JaxStreamer(jm, params, x, music, W, S)
    for upto in (3, W, W + 1, 19, 30, full.shape[2], full.shape[2] + 9):  # the last holds the last frame
        got = ours.frames(upto)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.frames(upto)), atol=1e-4, rtol=1e-4,
                                   err_msg=f"upto={upto}")
        assert torch.equal(got[:, :, :full.shape[2]], full[:, :, :upto]), f"upto={upto}"
    assert torch.equal(got[:, :, -10:], full[:, :, -1:].expand(-1, -1, 10, -1))
    fresh = TrajectoryStreamer(tmodel, x, music, W, S)  # lazy: only as far as asked
    fresh.frames(3)
    assert fresh.next_start == 0
    fresh.frames(W + 1)
    assert fresh.next_start == S * 2


def test_postprocess_matches_jax():
    rng = np.random.default_rng(8)
    traj = _walk(9, (2, 3, 30, 2)) * 0.01
    tol = dict(atol=1e-6, rtol=1e-5)
    for length in (30, 8):  # the window shrinks to the odd length at most the clip's
        arr = traj[:, :, :length]
        ref = jax_post.smooth_data(arr)
        np.testing.assert_array_equal(postprocess.smooth_data(arr), ref)
        np.testing.assert_array_equal(postprocess.smooth_data(torch.from_numpy(arr)).numpy(), ref)
    offset, start = traj[:, :, 1:] - traj[:, :, :-1], traj[:, :, :1]
    np.testing.assert_allclose(postprocess.offset2xyz(torch.from_numpy(offset), torch.from_numpy(start)).numpy(),
                               np.asarray(jax_post.offset2xyz(offset, start)), **tol)
    np.testing.assert_allclose(postprocess.process_traj(torch.from_numpy(traj)).numpy(),
                               np.asarray(jax_post.process_traj(traj)), **tol)
    log = rng.normal(size=17)
    assert postprocess.get_ci(log) == jax_post.get_ci(log)
    motion = rng.normal(size=(2, 12, 72)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(2, 12, 3))).astype(np.float32)
    ours = postprocess.get_motion_with_trans(torch.from_numpy(motion), torch.from_numpy(vel))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_post.get_motion_with_trans(motion, vel)), **tol)
