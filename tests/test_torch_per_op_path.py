"""The per-op serving configuration of the port against the JAX package in
the same configuration.

JAX: TCDIFF_PALLAS_SAB=0 TCDIFF_PALLAS_FFB=0 TCDIFF_PALLAS_LN=1
TCDIFF_PALLAS_LNMM=1 TCDIFF_PALLAS_LNROT=1 TCDIFF_PALLAS_ATTENTION=1|2,
TCDIFF_KV_CACHE=1|0, its Pallas kernels in interpret mode (the flags are
read while the JAX code traces, so each test sets them first). Port:
`ServingKernels.per_op(attention, kv_cache)`, whose CPU tensors take the
kernels' plain versions. The flax tree is initialised under the flags and
loaded strictly. A small config (2 layers, d=64, 4 heads x 16, 16 frames x
3 dancers), f32; tolerance 3e-5 abs/rel (the paths differ only in the
order of f32 sums); timesteps below 64 (see tests/test_torch_dance_decoder.py).
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


def _set_flags(mp, attention: int, kv_cache: bool):
    for name, value in (("SAB", "0"), ("FFB", "0"), ("FFT", "0"), ("LN", "1"), ("LNMM", "1"), ("LNROT", "1"),
                        ("ATTENTION", str(attention))):
        mp.setenv(f"TCDIFF_PALLAS_{name}", value)
    mp.setenv("TCDIFF_KV_CACHE", "1" if kv_cache else "0")


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, CFG.tokens, CFG.nfeats)).astype(np.float32)
    cond = rng.normal(size=(b, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)).astype(np.float32)
    t = rng.integers(0, 64, size=(b,)).astype(np.int32)
    dist = rng.integers(0, 10, size=(b, CFG.tokens, CFG.tokens)).astype(np.int32)
    return x, cond, t, dist


@pytest.fixture(scope="module")
def models():
    x, cond, t, _ = _inputs(2, 0)  # the forward tests' shapes: their Pallas programs compile once
    jmodel = JaxDecoder(CFG)
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, 1, True)
        params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))["params"]
    rng = np.random.default_rng(9)  # every leaf nonzero, so that each one shows
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    tmodel = load_jax_params(DanceDecoder(CFG, device="cpu"), params)
    return jmodel, params, tmodel.eval()


def test_per_op_config_and_flags():
    k = ServingKernels.per_op(attention=2, kv_cache=False)
    env = {"TCDIFF_PALLAS_SAB": "0", "TCDIFF_PALLAS_FFB": "0", "TCDIFF_PALLAS_LN": "1",
           "TCDIFF_PALLAS_LNMM": "1", "TCDIFF_PALLAS_LNROT": "1", "TCDIFF_PALLAS_ATTENTION": "2",
           "TCDIFF_KV_CACHE": "0"}
    assert ServingKernels.from_env(env) == k
    assert ServingKernels.from_env({}) == ServingKernels()
    assert not (k.sa_block or k.ff_block or k.kv_cache) and k.ln_rotary and k.attention == 2


def test_serving_flags_of_the_block_kernels():
    """from_env reads TCDIFF_FUSE_FILM and TCDIFF_LAYER_FUSE_FF too."""
    env = {"TCDIFF_FUSE_FILM": "1", "TCDIFF_LAYER_FUSE": "1", "TCDIFF_LAYER_FUSE_FF": "0"}
    assert ServingKernels.from_env(env) == ServingKernels(fuse_film=True, layer_fuse=True, layer_fuse_ff=False)
    assert not ServingKernels().fuse_film and ServingKernels().layer_fuse_ff


def _counted(tmodel, site: str):
    """Count the calls of every layer's `site` kernel function; returns the
    list the calls append to and a function that restores the layers."""
    calls, saved = [], [(layer, getattr(layer, site)) for layer in tmodel.layers]
    for layer, fn in saved:
        setattr(layer, site, lambda *a, _fn=fn, **kw: calls.append(1) or _fn(*a, **kw))
    return calls, lambda: [setattr(layer, site, fn) for layer, fn in saved]


def _guided(tmodel, kernels, x, cond, t):
    tmodel.kernels = kernels
    d = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    with torch.no_grad():
        return d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                        cond_cache=d.encode_cond_cfg(torch.from_numpy(cond)))


@pytest.mark.parametrize("kw, item", [
    (dict(ff_tail=False), "K2b"), (dict(layer_fuse=True), "K6"), (dict(ca_block=True, kv_cache=False), "K7"),
])
def test_unported_combinations_raise(models, kw, item):
    """The combinations that raised NotImplementedError while K2b, K6 and
    K7 were unported now construct, and a guided step runs through the
    kernel, on every layer but the CFG-dedup one for K6, and agrees with
    the default configuration: no combination is left to raise."""
    _, _, tmodel = models
    x, cond, t, _ = _inputs(1, 1)
    ref = _guided(tmodel, ServingKernels(), x, cond, t)
    site = {"K2b": "ff_block_fn", "K6": "layer_fn", "K7": "ca_block_fn"}[item]
    calls, restore = _counted(tmodel, site)
    try:
        out = _guided(tmodel, ServingKernels(**kw), x, cond, t)
    finally:
        restore()
        tmodel.kernels = ServingKernels()
    assert len(calls) == CFG.num_layers - (item == "K6")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_xab_with_the_cache_on_raises_where_k7_would_run(models):
    """With the k/v cache on, the cross-attention block kernel takes its
    form over the hoisted k/v on the cached path (ca_kv, never the memory
    form), and the uncached forward, which once raised there, runs the
    memory form on every layer; both agree with the plain site."""
    _, _, tmodel = models
    x, cond, t, _ = _inputs(1, 1)
    kernels, plain = ServingKernels(ca_block=True), ServingKernels(ca_block=False)
    calls, restore = _counted(tmodel, "ca_block_fn")
    kv_calls, restore_kv = _counted(tmodel, "ca_kv_fn")
    try:
        cached = _guided(tmodel, kernels, x, cond, t)
        assert not calls and len(kv_calls) == CFG.num_layers
        cached_ref = _guided(tmodel, plain, x, cond, t)
        tmodel.kernels = kernels
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
        tmodel.kernels = plain
        with torch.no_grad():
            ref = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
    finally:
        restore()
        restore_kv()
        tmodel.kernels = ServingKernels()
    assert len(calls) == CFG.num_layers and len(kv_calls) == CFG.num_layers
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(cached.numpy(), cached_ref.numpy(), **TOL)


@pytest.mark.parametrize("attention", [1, 2])
@pytest.mark.parametrize("trpe", [False, True])
def test_uncached_forward_matches_jax(models, monkeypatch, attention, trpe):
    """No cond cache: the memory path, whose cross-attention query side
    takes K8's rot-only form."""
    jmodel, params, tmodel = models
    _set_flags(monkeypatch, attention, True)
    x, cond, t, dist = _inputs(2, 2)
    keep = np.array([True, False])
    td = dist if trpe else None
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t), jnp.asarray(keep),
                       None if td is None else jnp.asarray(td))
    tmodel.kernels = ServingKernels.per_op(attention)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(keep),
                     None if td is None else torch.from_numpy(td))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("attention, kv_cache, trpe", [(1, True, True), (2, True, False), (1, False, True),
                                                       (2, False, False), (2, True, True), (1, False, False)])
def test_cached_guided_forward_matches_jax(models, monkeypatch, attention, kv_cache, trpe):
    """encode_cond_cfg + guided (CFG dedup at layer 0), with the k/v cache
    hoisted or the memory path; every layer's self-attention q, k, v come
    from one K8 call with q's and k's weights apart."""
    jmodel, params, tmodel = models
    _set_flags(monkeypatch, attention, kv_cache)
    x, cond, t, dist = _inputs(2, 3)
    td = dist if trpe else None
    jd = JaxDiffusion(jmodel, DiffusionConfig())
    jcache = jd.encode_cond_cfg(params, jnp.asarray(cond))
    ref = jd.guided(params, jnp.asarray(x), None, jnp.asarray(t), 2.0, None if td is None else jnp.asarray(td),
                    cond_cache=jcache)
    tmodel.kernels = ServingKernels.per_op(attention, kv_cache)
    d = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    with torch.no_grad():
        cache = d.encode_cond_cfg(torch.from_numpy(cond))
        out = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                       None if td is None else torch.from_numpy(td), cond_cache=cache)
    assert (cache.kv is not None) == kv_cache == (len(jcache) == 4)
    np.testing.assert_allclose(cache.ct.numpy(), np.asarray(jcache[0]), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("attention, kv_cache, trpe", [(1, True, True), (2, False, False)])
def test_ddim_sample_matches_jax(models, monkeypatch, attention, kv_cache, trpe):
    """A 3-step ddim_sample through the per-op configuration on injected
    noise (60 timesteps, so every t stays below 64). The final layer is
    scaled by 0.1, so that the x0 predictions stay mostly inside the clamp:
    the steps carry absolute differences, and at the random weights' output
    scale (~10) the order of f32 sums alone moves them past 3e-5."""
    jmodel, params, _ = models
    _set_flags(monkeypatch, attention, kv_cache)
    params = dict(params, final_layer={k: 0.1 * v for k, v in params["final_layer"].items()})
    tmodel = load_jax_params(DanceDecoder(CFG, device="cpu"), params).eval()
    b, steps = 2, 3
    shape = (b, CFG.tokens, CFG.nfeats)
    rng = np.random.default_rng(4)
    _, cond, _, dist = _inputs(b, 5)
    x_0 = (0.1 * rng.normal(size=(b, CFG.tokens, 3))).astype(np.float32)
    noise = {"init": rng.normal(size=shape).astype(np.float32),
             "steps": rng.normal(size=(steps,) + shape).astype(np.float32)}
    dcfg = DiffusionConfig(n_timestep=60, sampling_timesteps=steps)
    td = dist if trpe else None
    ref = JaxDiffusion(jmodel, dcfg).ddim_sample(params, shape, jnp.asarray(cond), jax.random.key(1),
                                                 jnp.asarray(x_0), noise, None if td is None else jnp.asarray(td))
    tmodel.kernels = ServingKernels.per_op(attention, kv_cache)
    out = GaussianDiffusion(tmodel, dcfg, device="cpu").ddim_sample(
        shape, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise,
        trj_dist=None if td is None else torch.from_numpy(td))
    np.testing.assert_array_equal(out[..., 4:6].numpy(), x_0[..., :2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
