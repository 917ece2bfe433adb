"""The port's samplers beyond ddim_sample against the JAX package's, on
injected noise: long-form, footwork, streaming (first and second slice),
the x0 forecast, the DDPM loop (normal, inpaint, long) and partial
denoising; and the inpainting masks.

The draws the JAX samplers make inside their loop even when noise is
given (the stream inpaint's re-noising, the inpaint constraint's, and all
of partial_denoise's) are reproduced here with jax.random from the same
key-split sequence and handed to the port. Both sides run their default
serving path (the port's K1/K2 plain versions, the JAX package's XLA path
on the CPU). A small config (2 layers, d=64, 4 heads x 16, 16 frames x 3
dancers), f32, tolerance 3e-5 abs/rel. Every timestep stays below 64 (DDIM
over 60, DDPM over 20), and the final layer is scaled by 0.1 so that the x0
predictions stay mostly inside the clamp (see test_torch_per_op_path.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion import masks as jax_masks  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_torch.diffusion import masks  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402

CFG = DanceDecoderConfig(
    seq_len=16, latent_dim=64, ff_size=64, num_layers=2, num_heads=4,
    cond_feature_dim=24, dancer_num=3, head_dim=16,
)
# footwork frames inside the 16-frame clip: lo+w .. seq-w runs past hi-w
DDIM = DiffusionConfig(n_timestep=60, sampling_timesteps=6, footwork_frames=(4, 12), footwork_blend_width=3)
DDPM = DiffusionConfig(n_timestep=20)
TOL = dict(atol=3e-5, rtol=3e-5)
B = 3
SHAPE = (B, CFG.tokens, CFG.nfeats)
HALF = CFG.seq_len // 2


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDecoder(CFG)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1,) + SHAPE[1:]),
                                  jnp.zeros((1, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)),
                                  jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(9)  # every leaf nonzero, so that each one shows
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    params = dict(params, final_layer={k: 0.1 * v for k, v in params["final_layer"].items()})
    return jmodel, params, load_jax_params(DanceDecoder(CFG, device="cpu"), params).eval()


def _data(seed, steps, b=B):
    rng = np.random.default_rng(seed)
    shape = (b,) + SHAPE[1:]
    cond = rng.normal(size=(b, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)).astype(np.float32)
    x_0 = (0.5 * rng.normal(size=shape)).clip(-1, 1).astype(np.float32)  # XY trajectory in channels 0, 1
    noise = {"init": rng.normal(size=shape).astype(np.float32),
             "steps": rng.normal(size=(steps,) + shape).astype(np.float32)}
    return cond, x_0, noise


def _pair(models, dcfg):
    jmodel, params, tmodel = models
    return params, JaxDiffusion(jmodel, dcfg), GaussianDiffusion(tmodel, dcfg, device="cpu")


def _check(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_long_ddim_sample_matches_jax(models):
    params, jd, td = _pair(models, DDIM)
    cond, x_0, noise = _data(1, DDIM.sampling_timesteps)
    ref = jd.long_ddim_sample(params, SHAPE, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0), noise)
    out = td.long_ddim_sample(SHAPE, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise)
    _check(out, ref)
    # the slices are coupled: slice i's first half-window is slice i-1's second
    x4 = out.reshape(B, CFG.seq_len, -1, CFG.nfeats)
    assert not torch.equal(x4[1:, :HALF], x4[:-1, HALF:])  # the last step does not couple


def test_long_ddim_one_slice_is_ddim_sample_without_trajectory(models):
    _, _, td = _pair(models, DDIM)
    cond, x_0, noise = _data(2, DDIM.sampling_timesteps, b=1)
    shape = (1,) + SHAPE[1:]
    out = td.long_ddim_sample(shape, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise)
    ref = td.ddim_sample(shape, torch.from_numpy(cond), noise=noise)
    assert torch.equal(out, ref)


def test_ddim_sample_footwork_matches_jax(models):
    params, jd, td = _pair(models, DDIM)
    cond, x_0, noise = _data(3, DDIM.sampling_timesteps)
    ref = jd.ddim_sample_footwork(params, SHAPE, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0), noise)
    out = td.ddim_sample_footwork(SHAPE, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise)
    _check(out, ref)
    # the quirk: frames [hi - w, seq - w) of a spliced channel end equal to x_0
    o4 = out.reshape(B, CFG.seq_len, -1, CFG.nfeats)
    r4 = torch.from_numpy(x_0).reshape(o4.shape)
    assert torch.equal(o4[:, 9:13, :, 13:19], r4[:, 9:13, :, 13:19])


def _stream_prev_noise(rng_key, steps, b):
    """The JAX stream sampler's in-loop draws with injected step noise:
    (k_init, k_scan) = split(key); each step splits k_scan once more."""
    key = jax.random.split(rng_key)[1]
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (b, HALF, CFG.dancer_num, CFG.nfeats), jnp.float32)))
    return np.stack(out).reshape(steps, b, HALF * CFG.dancer_num, CFG.nfeats)


@pytest.mark.parametrize("second_slice", [False, True])
def test_ddim_sample_stream_matches_jax(models, second_slice):
    params, jd, td = _pair(models, DDIM)
    steps = DDIM.sampling_timesteps
    cond, x_0, noise = _data(4, steps)
    prev = None
    if second_slice:
        prev = (0.5 * np.random.default_rng(5).normal(size=(B, HALF * CFG.dancer_num, CFG.nfeats))).astype(np.float32)
        noise = dict(noise, prev=_stream_prev_noise(jax.random.key(1), steps, B))
    ref = jd.ddim_sample_stream(params, SHAPE, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0),
                                None if prev is None else jnp.asarray(prev), noise)
    out = td.ddim_sample_stream(SHAPE, torch.from_numpy(cond), x_0=torch.from_numpy(x_0),
                                prev_tail=None if prev is None else torch.from_numpy(prev), noise=noise)
    _check(out, ref)
    if second_slice:  # the last step leaves the previous tail un-noised in the first half-window
        first = out.reshape(B, CFG.seq_len, -1, CFG.nfeats)[:, :HALF, :, 6:]
        assert torch.equal(first, torch.from_numpy(prev).reshape(B, HALF, -1, CFG.nfeats)[..., 6:])


def test_ddim_sample_forecast_matches_jax(models):
    """forecast_every=2 over 6 steps: the model runs at steps 0, 1, 2, 4
    and 5, and step 3 extrapolates."""
    params, jd, td = _pair(models, DDIM)
    cond, x_0, noise = _data(6, DDIM.sampling_timesteps)
    ref = jd.ddim_sample(params, SHAPE, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0), noise,
                         forecast_every=2)
    calls = []
    guided = td.guided
    td.guided = lambda *a, **k: calls.append(1) or guided(*a, **k)
    out = td.ddim_sample(SHAPE, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise, forecast_every=2)
    assert len(calls) == 5
    _check(out, ref)


def _loop_draws(rng_key, steps, shape):
    """p_sample_loop's in-loop draws: (k_init, k_scan) = split(key); each
    step splits k_scan once more."""
    key = jax.random.split(rng_key)[1]
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("mode", ["normal", "inpaint", "long"])
def test_p_sample_loop_matches_jax(models, mode):
    params, jd, td = _pair(models, DDPM)
    steps = DDPM.n_timestep
    cond, x_0, noise = _data(7, steps)
    constraint = tconstraint = None
    if mode == "inpaint":
        mask = np.array(jax_masks.lowerbody_mask(SHAPE))
        constraint = {"mask": jnp.asarray(mask), "value": jnp.asarray(x_0)}
        tconstraint = {"mask": torch.from_numpy(mask), "value": torch.from_numpy(x_0)}
        noise = dict(noise, value=_loop_draws(jax.random.key(1), steps, SHAPE))
    ref = jd.p_sample_loop(params, SHAPE, jnp.asarray(cond), jax.random.key(1), noise, mode=mode,
                           constraint=constraint)
    out = td.p_sample_loop(SHAPE, torch.from_numpy(cond), noise=noise, mode=mode, constraint=tconstraint)
    _check(out, ref)


def test_partial_denoise_matches_jax(models):
    params, jd, td = _pair(models, DDPM)
    t = 5
    cond, x_0, _ = _data(8, 0)
    k_q, k_loop = jax.random.split(jax.random.key(2))
    noise = {"q": np.array(jax.random.normal(k_q, SHAPE, jnp.float32)), "steps": _loop_draws(k_loop, t, SHAPE)}
    ref = jd.partial_denoise(params, jnp.asarray(x_0), jnp.asarray(cond), t, jax.random.key(2))
    out = td.partial_denoise(torch.from_numpy(x_0), torch.from_numpy(cond), t, noise=noise)
    _check(out, ref)


def test_schedule_posterior_tables_match_exactly():
    from tcdiff_tpu.diffusion.schedules import DiffusionBuffers as JaxBuffers
    from tcdiff_torch.diffusion.schedules import DiffusionBuffers

    for schedule in ("cosine", "linear"):
        ours, ref = DiffusionBuffers.create(schedule, 1000), JaxBuffers.create(schedule, 1000)
        for f in dataclasses.fields(ours):
            np.testing.assert_array_equal(getattr(ours, f.name), getattr(ref, f.name), err_msg=f.name)


@pytest.mark.parametrize("name, kw", [
    ("first_last_mask", dict(start_width=2, end_width=3)), ("first_mask", dict(start_width=4)),
    ("middle_mask", dict(start=2, end=-5)), ("lowerbody_mask", {}), ("upperbody_mask", {}),
])
def test_masks_match_jax(name, kw):
    shape = (2, CFG.tokens, CFG.nfeats)
    out = getattr(masks, name)(shape, **kw, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jax_masks, name)(shape, **kw)))
    assert masks.joint_indices_to_channel_indices([0, 23]) == jax_masks.joint_indices_to_channel_indices([0, 23])
