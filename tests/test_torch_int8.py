"""TCDIFF_INT8 serving in the port (`ops/int8.py`, `ServingKernels.int8`)
against the JAX package's `ops/int8.py` and int8 model, on the CPU.

  * scales: quantize_weight's and quantize_act's equal JAX's to f32
    rounding (1 ulp);
  * codes: equal, except where x/scale lies within a few ulps of a .5 tie:
    there the two packages' f32 quotients may round to either side, a
    code one step apart. The test counts those codes and requires every
    other code to be equal;
  * int8_dense: within 1e-6 relative to JAX's (the same int32 sums; the
    dequantization's f32 products in one order);
  * the int8 model forward (TCDIFF_INT8=1, f32, test_int8.py's config: 2
    layers, d=64, 4 heads x 16) and the guided forward over the hoisted
    k/v: the same sites in the same order, each site of the port fed JAX's
    input there within 1e-6 of JAX's output, and each output row within
    1e-4 of JAX's largest output unless one of its activation codes met a
    tie. Across the packages a site's f32 input differs by ~1e-6, so a
    value within that of a .5 tie gets codes one step apart, and the step
    spreads through the rest of that row (the seeded input here has one
    such code, at x/scale = -119.50002 in the first site of its second
    row, which then differs by 1.4% of the largest output). The test
    finds where each row's codes first differ, requires those to be ties,
    and holds the other rows;
  * `ServingKernels.from_env` turns the block kernels' defaults off under
    TCDIFF_INT8, and an explicit 1 still wins with a one-time warning.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import CFG, inputs, load_models  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.ops import int8 as jint8  # noqa: E402
from tcdiff_torch import ServingKernels  # noqa: E402
from tcdiff_torch import config as tconfig  # noqa: E402
from tcdiff_torch.config import DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.ops import int8  # noqa: E402

TIE = 4e-7  # |frac(|x/scale|) - 0.5| below this (a few f32 ulps of the quotient): either code is a rounding


def _tied_codes(mine, ref, quotient) -> int:
    """Codes that differ: each must be one step apart on a .5 tie of the
    float64 quotient; returns their count."""
    off = mine.astype(np.int32) != ref.astype(np.int32)
    frac = np.abs(np.abs(quotient) - np.floor(np.abs(quotient)) - 0.5)
    assert np.all(np.abs(mine.astype(np.int32) - ref.astype(np.int32))[off] == 1)
    assert np.all(frac[off] < TIE), frac[off].max()
    return int(off.sum())


def test_quantize_weight_and_act_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(512, 256)).astype(np.float32)  # JAX layout (in, out)
    x = rng.normal(size=(3, 100, 512)).astype(np.float32)
    jwq, jsw = (np.asarray(a) for a in jint8.quantize_weight(jnp.asarray(w)))
    wq, sw = int8.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_allclose(sw.numpy(), jsw, rtol=2**-23, atol=0)
    tied_w = _tied_codes(wq.numpy().T, jwq, w.astype(np.float64) / jsw.astype(np.float64))
    jxq, jsx = (np.asarray(a) for a in jint8._quantize_act(jnp.asarray(x)))
    xq, sx = int8.quantize_act(torch.from_numpy(x))
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=2**-23, atol=0)
    tied_x = _tied_codes(xq.numpy(), jxq, x.astype(np.float64) / jsx.astype(np.float64)[..., None])
    assert xq.dtype == wq.dtype == torch.int8 and int(xq.abs().max()) == int(wq.abs().max()) == 127
    assert tied_w + tied_x <= 1e-3 * (w.size + x.size), (tied_w, tied_x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    w = rng.normal(size=(512, 256)).astype(np.float32)
    b = rng.normal(size=(256,)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jint8.int8_dense(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    wq, sw = int8.quantize_weight(torch.from_numpy(w.T.copy()))
    out = int8.int8_dense(torch.from_numpy(x).to(dtype), wq, sw, torch.from_numpy(b))
    assert out.dtype == dtype and out.shape == (64, 256)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    else:  # the same f32 value rounded to bf16: equal but where it lies on a bf16 tie
        assert np.mean(out.float().numpy() != ref) < 1e-3
    exact = x @ w + b
    assert np.linalg.norm(out.float().numpy() - exact) < 0.02 * np.linalg.norm(exact)


def test_quantized_weight_is_kept_until_the_parameter_changes():
    p = torch.nn.Parameter(torch.randn(16, 8))
    first = int8.quantized_weight(p)
    assert int8.quantized_weight(p)[0] is first[0]
    with torch.no_grad():
        p.mul_(2.0)
    again = int8.quantized_weight(p)
    assert again[0] is not first[0] and torch.equal(again[1], 2.0 * first[1])


def _spy(monkeypatch):
    """Record both packages' int8_dense calls in order: JAX's (input,
    output), the port's (input, codes, scales, bias)."""
    jcalls, tcalls = [], []
    jreal, treal = jint8.int8_dense, int8.int8_dense

    def jspy(a, *rest, **kw):
        out = jreal(a, *rest, **kw)
        jcalls.append((np.asarray(a), np.asarray(out)))
        return out

    def tspy(a, wq, sw, bias=None):
        tcalls.append((a.numpy(), wq, sw, bias))
        return treal(a, wq, sw, bias)

    monkeypatch.setattr(jint8, "int8_dense", jspy)  # imported inside the JAX layers at each call
    monkeypatch.setattr(int8, "int8_dense", tspy)
    return jcalls, tcalls


def _check_int8_path(jcalls, tcalls, out, ref, sites: int):
    """The sites in the same order; each site of the port, fed JAX's input
    there, gives JAX's output within 1e-6; and each output row within 1e-4
    of JAX's largest output, unless a code of that row was tied: where
    the two packages' own inputs to a site first round to different codes,
    each differing code must lie within 1e-3 of a .5 tie (their f32 inputs
    differ by ~1e-6 there), and from then on the row differs by what that
    code step sets off. Returns the rows held to 1e-4."""
    assert len(jcalls) == len(tcalls) == sites
    b = out.shape[0]
    tied = set()
    for (jx, jy), (tx, wq, sw, bias) in zip(jcalls, tcalls):
        assert jx.shape == tx.shape
        with torch.no_grad():
            y = int8.int8_dense(torch.from_numpy(jx.copy()), wq, sw, bias).numpy()
        np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6 * np.abs(jy).max())
        jq, js = (np.asarray(a) for a in jint8._quantize_act(jnp.asarray(jx)))
        tq = int8.quantize_act(torch.from_numpy(tx.copy()))[0].numpy()
        for idx in np.argwhere(jq != tq):
            row = int(idx[0]) % b
            if row not in tied:
                q = jx[tuple(idx)] / js[tuple(idx[:-1])]
                assert abs(abs(q) - np.floor(abs(q)) - 0.5) < 1e-3, q
                tied.add(row)
    held = [r for r in range(b) if r not in tied]
    assert held, "every row met a tied code"
    np.testing.assert_allclose(out[held], ref[held], rtol=0, atol=1e-4 * np.abs(ref).max())
    return held


def test_int8_model_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("TCDIFF_INT8", "1")
    for name in ("TCDIFF_PALLAS_SAB", "TCDIFF_PALLAS_FFB", "TCDIFF_PALLAS_FFT"):
        monkeypatch.delenv(name, raising=False)
    jmodel, params, tmodel = load_models()
    tmodel.kernels = ServingKernels.from_env()
    assert tmodel.kernels.int8 and not (tmodel.kernels.sa_block or tmodel.kernels.ff_block)
    x, cond, t = inputs(2, 1)
    keep = np.array([True, False])
    jcalls, tcalls = _spy(monkeypatch)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t),
                                  jnp.asarray(keep)))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(keep))
    # per layer: self-attention q, k, v, fc; cross-attention q, k, v, fc (no hoist); FF linear1-3
    _check_int8_path(jcalls, tcalls, out.numpy(), ref, 11 * CFG.num_layers)

    # the guided forward over the hoisted k/v: cross-attention q stays float
    jd = JaxDiffusion(jmodel, JaxDiffusionConfig())
    jcache = jd.encode_cond_cfg(params, jnp.asarray(cond))
    jcalls.clear()
    ref = np.asarray(jd.guided(params, jnp.asarray(x), None, jnp.asarray(t), 2.0, cond_cache=jcache))
    d = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    tcalls.clear()
    with torch.no_grad():
        out = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                       cond_cache=d.encode_cond_cfg(torch.from_numpy(cond)))
    _check_int8_path(jcalls, tcalls, out.numpy(), ref, 8 * CFG.num_layers)
    with torch.no_grad():
        tmodel.kernels = ServingKernels()
        exact = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                         cond_cache=d.encode_cond_cfg(torch.from_numpy(cond)))
    rel = np.linalg.norm(out.numpy() - exact.numpy()) / np.linalg.norm(exact.numpy())
    assert 0 < rel < 0.05, rel  # tests/test_int8.py's model-level bound


def test_from_env_turns_the_block_defaults_off_under_int8(monkeypatch):
    assert ServingKernels.from_env({}) == ServingKernels() and ServingKernels().sa_block
    k = ServingKernels.from_env({"TCDIFF_INT8": "1"})
    assert k.int8 and not (k.sa_block or k.ff_block or k.ff_tail)
    assert k == ServingKernels(int8=True)
    assert ServingKernels.from_env({"TCDIFF_INT8": "1", "TCDIFF_PALLAS_FFB": "0"}).ff_tail is False
    monkeypatch.setattr(tconfig, "_WARNED_INT8_SHADOW", set())
    with pytest.warns(UserWarning, match="TCDIFF_PALLAS_SAB=1"):
        k = ServingKernels.from_env({"TCDIFF_INT8": "1", "TCDIFF_PALLAS_SAB": "1"})
    assert k.sa_block and not k.ff_block
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServingKernels.from_env({"TCDIFF_INT8": "1", "TCDIFF_PALLAS_SAB": "1"})  # once only
