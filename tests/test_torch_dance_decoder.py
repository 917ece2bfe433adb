"""The port's DanceDecoder against the flax module, on flax-made weights.

A small config (2 layers, d=64, 4 heads x 16, seq 16 x 3 dancers) is
initialised in flax, loaded into the port with `strict=True`, and fed the
same seeded numpy inputs. f32 on the CPU; tolerance 3e-5 abs/rel, as the
JAX package's own kernel-vs-flax tests (the paths differ only in the
order of f32 sums). Timesteps stay below 64: XLA's f32 exp puts the
timestep-embedding frequencies 1 ulp away from PyTorch's, and sin(t * f)
multiplies that by t (6e-5 at t = 999, 4e-6 below 64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402

CFG = DanceDecoderConfig(
    seq_len=16, latent_dim=64, ff_size=64, num_layers=2, num_heads=4,
    cond_feature_dim=24, dancer_num=3, head_dim=16,
)
TOL = dict(atol=3e-5, rtol=3e-5)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, CFG.tokens, CFG.nfeats)).astype(np.float32)
    cond = rng.normal(size=(b, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)).astype(np.float32)
    t = rng.integers(0, 64, size=(b,)).astype(np.int32)
    return x, cond, t


@pytest.fixture(scope="module")
def models():
    x, cond, t = _inputs()
    jmodel = JaxDecoder(CFG)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))["params"]
    # the flax init leaves zeros in biases and LN shifts: perturb every
    # leaf so that each one shows in the comparison
    rng = np.random.default_rng(9)
    params = jax.tree.map(lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    tmodel = load_jax_params(DanceDecoder(CFG, device="cpu"), jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel.eval()


def test_load_jax_params_is_strict_and_exact(models):
    jmodel, params, tmodel = models
    sd = tmodel.state_dict()
    np.testing.assert_array_equal(
        sd["seqTransDecoder.stack.1.self_attn.w_qs.weight"].numpy(),
        np.asarray(params["decoder_1"]["self_attn"]["w_qs"]["kernel"]).T,
    )
    np.testing.assert_array_equal(
        sd["cond_encoder.0.self_attn.in_proj_bias"].numpy()[: CFG.latent_dim],
        np.asarray(params["cond_encoder_0"]["self_attn"]["q_proj"]["bias"]),
    )
    n_leaves = len(jax.tree.leaves(params))
    n_rotary = sum(k.endswith("rotary.freqs") for k in sd)
    # each cond-encoder layer packs its 6 q/k/v leaves into in_proj_{weight,bias}
    assert len(sd) - n_rotary == n_leaves - 4 * 2


def test_forward_matches_flax_uncached(models):
    jmodel, params, tmodel = models
    x, cond, t = _inputs(b=2, seed=1)
    keep = np.array([True, False])
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t),
                       jnp.asarray(keep))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t),
                     torch.from_numpy(keep))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_forward_matches_flax_with_trpe(models):
    jmodel, params, tmodel = models
    x, cond, t = _inputs(b=2, seed=2)
    dist = np.random.default_rng(3).integers(0, 10, size=(2, CFG.tokens, CFG.tokens)).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t),
                       None, jnp.asarray(dist))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t),
                     None, torch.from_numpy(dist))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cond_cache_and_guided_match_jax_kernels(models, monkeypatch):
    """encode_cond_cfg + guided (CFG dedup, hoisted k/v) against the JAX
    sampler with its serving kernels switched on (interpret mode)."""
    for flag in ("TCDIFF_PALLAS_SAB", "TCDIFF_PALLAS_FFB", "TCDIFF_PALLAS_FFT"):
        monkeypatch.setenv(flag, "1")
    jax.clear_caches()
    jmodel, params, tmodel = models
    x, cond, t = _inputs(b=2, seed=4)
    jd = JaxDiffusion(jmodel, DiffusionConfig())
    jcache = jd.encode_cond_cfg(params, jnp.asarray(cond))
    ref = jd.guided(params, jnp.asarray(x), None, jnp.asarray(t), 2.0, cond_cache=jcache)

    td = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    with torch.no_grad():
        cache = td.encode_cond_cfg(torch.from_numpy(cond))
        out = td.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0, cond_cache=cache)
    np.testing.assert_allclose(cache.ct.numpy(), np.asarray(jcache[0]), **TOL)
    np.testing.assert_allclose(cache.cond_hidden.numpy(), np.asarray(jcache[1]), **TOL)
    for (k, v), (jk, jv) in zip(cache.kv, jcache[2]):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
