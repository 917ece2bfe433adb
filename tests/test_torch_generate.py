"""The port's wav-to-dance serving path (tcdiff_torch/train/orchestrator.py)
against the JAX package's `TCDiff` methods, on the CPU: the windowing with
its short-audio padding and trailing-drop warning, `truncate_motion`, the
DBN trajectory stage of the dataset loops and `generate` (long-form over
several slices, with a trajectory shorter than the slices need, and one
padded slice); `generate_streaming` is held in
tests/test_torch_generate_stream.py, on this file's set-up.

The JAX side runs its own `TCDiff.generate` (on a TCDiff without a train
state) with the sampler's noise injected and rendering stubbed out. A
tiny decoder (2 layers, d=64, 16 frames x 3 dancers, 438 music
channels) and a small DBN (window 8, step 4, one block of 2 x 16); f32; 3 DDIM steps over 60 timesteps (every t
below 64, tests/test_torch_dance_decoder.py); the final layer scaled by
0.1 (x0 predictions mostly inside the clamp). Tolerance 3e-5.
"""

import dataclasses
import logging
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu import config as jcfg  # noqa: E402
from tcdiff_tpu.data.normalizer import Normalizer as JaxNormalizer  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.train import orchestrator as jorch  # noqa: E402
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder  # noqa: E402
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TrajDecoderConfig  # noqa: E402
from tcdiff_torch.data.audio import save_wav  # noqa: E402
from tcdiff_torch.data.features import SR  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params, load_jax_traj_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.train import orchestrator as orch  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402

MODEL = dict(seq_len=16, latent_dim=64, ff_size=64, num_layers=2, num_heads=4, cond_feature_dim=438,
             dancer_num=3, head_dim=16)
DIFF = dict(n_timestep=60, sampling_timesteps=3)
TRAJ = dict(window_size=8, step=4, trans_layer=1, latent_dim=16, n_head=2)
SEQ, DN, NF, STEPS = 16, 3, 151, DIFF["sampling_timesteps"]
TOL = dict(atol=3e-5, rtol=3e-5)


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)  # every leaf nonzero, so that each one shows
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def _traj_params(traj: dict, seed: int):
    jm = JaxTrajDecoder(jcfg.TrajDecoderConfig(**traj))
    w, s = traj["window_size"], traj["step"]
    return _perturbed(jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, DN, w, 2)),
                                       jnp.zeros((1, (w + s) * 2, 438)))["params"], seed)


class _Runner(jorch.TCDiff):
    """The JAX package's TCDiff with only what its serving methods read:
    the config, the diffusion over the denoiser, the normalizer, the
    weights (eval_params, _load_traj_params), a one-device mesh and a
    logger; no train state."""

    def __init__(self, cfg, params, traj_params, normalizer):
        self.cfg, self.normalizer, self.logger = cfg, normalizer, logging.getLogger("tcdiff_tpu")
        self.diffusion = JaxDiffusion(JaxDecoder(cfg.model), cfg.diffusion)
        self.mesh = types.SimpleNamespace(shape={"dp": 1})
        self.eval_params = lambda: params
        self._load_traj_params = lambda opt, model: traj_params
        # the samplers jitted once, with the noise an argument
        self.jitted = {name: jax.jit(getattr(self.diffusion, name), static_argnums=(1,))
                       for name in ("long_ddim_sample", "ddim_sample", "ddim_sample_stream")}


@pytest.fixture(scope="module")
def stack():
    """(the JAX TCDiff, the port's denoiser diffusion, DBN and normalizer),
    on the same weights and normalizer."""
    cfg = jcfg.TCDiffConfig(model=jcfg.DanceDecoderConfig(**MODEL), diffusion=jcfg.DiffusionConfig(**DIFF),
                            traj=jcfg.TrajDecoderConfig(**TRAJ))
    params = jax.jit(JaxDecoder(cfg.model).init)(jax.random.key(0), jnp.zeros((1, SEQ * DN, NF)),
                                        jnp.zeros((1, 2 * SEQ + 1, 438)), jnp.zeros((1,), jnp.int32))["params"]
    params = _perturbed(params, 9)
    params = dict(params, final_layer={k: 0.1 * v for k, v in params["final_layer"].items()})
    traj_params = _traj_params(TRAJ, 3)
    rng = np.random.default_rng(11)
    jnorm = JaxNormalizer.fit(jnp.asarray(rng.normal(size=(8, SEQ, NF)).astype(np.float32) * 2))
    runner = _Runner(cfg, params, traj_params, jnorm)
    state = jnorm.to_numpy()

    diffusion = GaussianDiffusion(load_jax_params(DanceDecoder(DanceDecoderConfig(**MODEL), device="cpu"),
                                                  params).eval(), DiffusionConfig(**DIFF), device="cpu")
    traj_model = load_jax_traj_params(TrajDecoder(TrajDecoderConfig(**TRAJ), device="cpu"), traj_params)
    return runner, diffusion, traj_model, Normalizer.from_torch_state(state["scale"], state["offset"], device="cpu")


def _wav(tmp_path, seconds: float, seed: int) -> str:
    """Quiet noise with a click every half second (tests/test_generate.py)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=int(seconds * SR)).astype(np.float32) * 1e-3
    for s in range(0, len(y), SR // 2):
        n = min(64, len(y) - s)
        y[s:s + n] += rng.normal(size=n).astype(np.float32) * 0.4
    path = str(tmp_path / f"song{seed}.wav")
    save_wav(path, y, SR)
    return path


class _Log:
    def __init__(self):
        self.messages = []

    def warning(self, fmt, *args):
        self.messages.append(fmt % args)


@pytest.mark.parametrize("frames", [19, 33, 73, 81, 90])
def test_window_starts_match_jax(frames, caplog):
    """Short audio padded (19), one exact window (33), a dropped tail (73),
    windows that cover it all (81), and a drop after four windows (90)."""
    feats = np.random.default_rng(frames).normal(size=(frames, 438)).astype(np.float32)
    log = _Log()
    ref = jorch.TCDiff._window_starts(types.SimpleNamespace(cfg=types.SimpleNamespace(
        model=types.SimpleNamespace(seq_len=SEQ)), logger=log), feats, "song.wav")
    with caplog.at_level(logging.WARNING, logger=orch.__name__):
        ours = orch.window_starts(feats, SEQ, "song.wav")
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1:] == ref[1:]
    assert [r.getMessage() for r in caplog.records] == log.messages
    assert bool(log.messages) == (frames in (19, 73, 90))
    with pytest.raises(ValueError, match="too short"):
        orch.window_starts(feats[:1], SEQ)


def test_truncate_motion_matches_jax():
    flat = np.random.default_rng(0).normal(size=(2, SEQ * DN, 5)).astype(np.float32)
    for m in (1, 9, SEQ, SEQ + 3):
        np.testing.assert_array_equal(orch.truncate_motion(torch.from_numpy(flat), SEQ, DN, m).numpy(),
                                      np.asarray(jorch.TCDiff._truncate_motion(jnp.asarray(flat), SEQ, DN, m)))


def test_dbn_traj_fn_matches_jax(stack):
    """b = 2 (the LSTM recurs over the batch), 40 frames; the music holds
    fewer, so the last frame is held."""
    runner, _, traj_model, _ = stack
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(2, DN, 40, NF)).astype(np.float32)
    cond = rng.normal(size=(2, 57, 438)).astype(np.float32)
    ref = np.asarray(jorch.TCDiff._make_dbn_traj_fn(runner, None)(x, cond))
    ours = orch.make_dbn_traj_fn(traj_model)(x, cond)
    assert ours.shape == (2, 40 * DN, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)
    xy = ours.numpy().reshape(2, 40, DN, 3)
    np.testing.assert_array_equal(xy[:, -1], xy[:, -2])  # held


def _noise(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (n, SEQ * DN, NF)
    return {"init": rng.normal(size=shape).astype(np.float32),
            "steps": rng.normal(size=(STEPS,) + shape).astype(np.float32)}


@pytest.mark.parametrize("case", ["long", "short_trajectory", "one_slice"])
def test_generate_matches_jax(stack, tmp_path, monkeypatch, case):
    """long: 1.2 s, 3 slices, the tail past the last window dropped.
    short_trajectory: a DBN of window 10 and step 6 on 0.9 s rolls 22
    frames for the 24 that 2 slices cover; the last frame is held.
    one_slice: 0.3 s, padded to one window, plain DDIM, truncated to its 9
    motion frames."""
    runner, diffusion, traj_model, normalizer = stack
    seconds = {"long": 1.2, "short_trajectory": 0.9, "one_slice": 0.3}[case]
    if case == "short_trajectory":
        traj = dict(TRAJ, window_size=10, step=6)
        traj_params = _traj_params(traj, 4)
        monkeypatch.setattr(runner, "cfg", dataclasses.replace(runner.cfg, traj=jcfg.TrajDecoderConfig(**traj)))
        monkeypatch.setattr(runner, "_load_traj_params", lambda opt, model: traj_params)
        traj_model = load_jax_traj_params(TrajDecoder(TrajDecoderConfig(**traj), device="cpu"), traj_params)
    wav = _wav(tmp_path, seconds, 7)
    n = {"long": 3, "short_trajectory": 2, "one_slice": 1}[case]
    noise = _noise(n, 1)
    seen = {}

    def sample_fn(name):
        def fn(params, shape, cond, rng, x_0):
            seen.update(x_0=np.asarray(x_0), shape=shape)
            return runner.jitted[name](params, shape, cond, rng, x_0, noise)
        return fn

    runner._long_sample_fn, runner._sample_fn = sample_fn("long_ddim_sample"), sample_fn("ddim_sample")
    monkeypatch.setattr(jorch, "render_sample", lambda samples, *a, **k: np.asarray(samples))
    ref = runner.generate(wav, types.SimpleNamespace())

    report = {}
    out = orch.generate(wav, diffusion, traj_model, normalizer, noise=noise, report=report)
    assert seen["shape"] == (n, SEQ * DN, NF) and report["slices"] == n
    np.testing.assert_allclose(report["x_0"].numpy(), seen["x_0"], atol=1e-5, rtol=1e-5)
    if case == "short_trajectory":
        assert report["traj"].shape[1] == 22 < (n - 1) * SEQ // 2 + SEQ
    assert out.shape == ref.shape == ((1, 9 * DN, NF) if case == "one_slice" else (n, SEQ * DN, NF))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    m = out.shape[1] // DN
    np.testing.assert_array_equal(out[..., 4:6].numpy(), report["x_0"][:, :m * DN, :2].numpy())
    assert set(report["seconds"]) == {"features", "dbn_rollout", "kalman", "sampling"}


def test_devices_must_agree(stack):
    _, diffusion, traj_model, normalizer = stack
    other = types.SimpleNamespace(device=torch.device("meta"), cfg=traj_model.cfg)
    with pytest.raises(ValueError, match="the DBN is on meta"):
        orch.generate_from_features(np.zeros((40, 438), np.float32), diffusion, other, normalizer)
