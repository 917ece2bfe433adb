"""Shared set-up of the tests that hold a serving configuration of the port
against the JAX model under the same flags (test_torch_block_paths.py,
test_torch_ca_block_path.py, test_torch_layer_path.py).

A small config (2 layers, d=64, 4 heads x 16, 16 frames x 3 dancers), f32;
tolerance 3e-5 abs/rel (the paths differ only in the order of f32 sums);
timesteps below 64 (see tests/test_torch_dance_decoder.py). Each case is
one set of the JAX package's serving flags over `BASE` (K1 and K2 on, as
on the TPU; TCDIFF_PALLAS_XAB unset, so that each package runs its own
default there: the JAX package XLA's code over the hoisted k/v, the port
K7 over them); the JAX Pallas kernels run in interpret mode, and the
flags are read while the JAX code traces, so a test sets them before each
call. The port runs `ServingKernels.from_env` of the same flags on CPU
tensors, which take the kernels' plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_torch import ServingKernels  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402

CFG = DanceDecoderConfig(
    seq_len=16, latent_dim=64, ff_size=64, num_layers=2, num_heads=4,
    cond_feature_dim=24, dancer_num=3, head_dim=16,
)
TOL = dict(atol=3e-5, rtol=3e-5)
BASE = {"TCDIFF_PALLAS_SAB": "1", "TCDIFF_PALLAS_FFB": "1", "TCDIFF_PALLAS_FFT": "1", "TCDIFF_FUSE_FILM": "0",
        "TCDIFF_PALLAS_LN": "0", "TCDIFF_PALLAS_LNMM": "0", "TCDIFF_PALLAS_LNROT": "0",
        "TCDIFF_PALLAS_ATTENTION": "0", "TCDIFF_KV_CACHE": "1", "TCDIFF_LAYER_FUSE": "0",
        "TCDIFF_LAYER_FUSE_FF": "1"}


def use_flags(mp, flags: dict) -> ServingKernels:
    """Set the JAX package's flags (`flags` over BASE) with the monkeypatch
    `mp`; return the port's configuration of the same flags."""
    flags = dict(BASE, **flags)
    for name, value in flags.items():
        mp.setenv(name, value)
    return ServingKernels.from_env(flags)


def inputs(b: int, seed: int):
    """x (b, tokens, nfeats), cond (b, 2*seq_len+1, cond_dim), t (b,) < 64."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, CFG.tokens, CFG.nfeats)).astype(np.float32)
    cond = rng.normal(size=(b, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)).astype(np.float32)
    t = rng.integers(0, 64, size=(b,)).astype(np.int32)
    return x, cond, t


def load_models(final_scale: float = 1.0):
    """(JAX model, its params, the port's model with them loaded strictly).
    Every leaf perturbed, so that each one shows; the final layer scaled by
    `final_scale` (a sampler's x0 predictions then stay mostly inside the
    clamp, tests/test_torch_per_op_path.py)."""
    x, cond, t = inputs(2, 0)
    jmodel = JaxDecoder(CFG)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))["params"]
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    params = dict(params, final_layer={k: final_scale * v for k, v in params["final_layer"].items()})
    tmodel = load_jax_params(DanceDecoder(CFG, device="cpu"), params)
    return jmodel, params, tmodel.eval()


def check_uncached_forward(models, seed: int = 1):
    """model.apply without a cond cache against the port's forward."""
    jmodel, params, tmodel = models
    x, cond, t = inputs(2, seed)
    keep = np.array([True, False])
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t), jnp.asarray(keep))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(keep))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def check_guided(models, seed: int = 2):
    """encode_cond_cfg + guided (CFG dedup at layer 0; the k/v hoisted
    unless the cache is off) against the JAX sampler's."""
    jmodel, params, tmodel = models
    x, cond, t = inputs(2, seed)
    jd = JaxDiffusion(jmodel, DiffusionConfig())
    jcache = jd.encode_cond_cfg(params, jnp.asarray(cond))
    ref = jd.guided(params, jnp.asarray(x), None, jnp.asarray(t), 2.0, cond_cache=jcache)
    d = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    with torch.no_grad():
        cache = d.encode_cond_cfg(torch.from_numpy(cond))
        out = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0, cond_cache=cache)
    assert (cache.kv is not None) == tmodel.kernels.kv_cache == (len(jcache) == 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def check_ddim_sample(models, steps: int = 3):
    """A `steps`-step ddim_sample on injected noise (60 timesteps, so every
    t stays below 64) against the JAX sampler's."""
    jmodel, params, tmodel = models
    b = 2
    shape = (b, CFG.tokens, CFG.nfeats)
    rng = np.random.default_rng(4)
    _, cond, _ = inputs(b, 5)
    x_0 = (0.1 * rng.normal(size=(b, CFG.tokens, 3))).astype(np.float32)
    noise = {"init": rng.normal(size=shape).astype(np.float32),
             "steps": rng.normal(size=(steps,) + shape).astype(np.float32)}
    dcfg = DiffusionConfig(n_timestep=60, sampling_timesteps=steps)
    ref = JaxDiffusion(jmodel, dcfg).ddim_sample(params, shape, jnp.asarray(cond), jax.random.key(1),
                                                 jnp.asarray(x_0), noise)
    out = GaussianDiffusion(tmodel, dcfg, device="cpu").ddim_sample(
        shape, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise)
    np.testing.assert_array_equal(out[..., 4:6].numpy(), x_0[..., :2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
