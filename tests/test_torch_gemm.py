"""The projection entry point of the port (`tcdiff_torch/ops/gemm.py`, the
product K1, K2 and the other kernels run) against the products and
epilogues of the JAX package's Pallas kernels, written as those kernels
write them: `jnp.dot(..., preferred_element_type=f32)`, the bias in f32,
`_gelu_exact`, the FiLM residual of `_ff_tail_kernel`.

On the CPU the port's wrapper runs its plain version. Same seeded numpy
inputs into both; ragged shapes (M = 1, 154; N = 50 and K = 100, not
multiples of 8). Tolerances: f32 1e-5 abs/rel (the order of f32 sums);
bf16 2^-5 of the largest reference value, the bound the CUDA kernels are
held to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.ops.fused_ff_block import _gelu_exact  # noqa: E402
from tcdiff_torch.ops import gemm as g  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(154, 48, 64, 77), (1, 50, 100, 1), (154, 50, 100, 2)]  # (M, N, K, L)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _jax_ref(a, w, epilogue, bias, resid, fs, fb, L, jd):
    """The Pallas kernels' product and epilogue: a . w^T in f32 sums."""
    acc = jnp.dot(jnp.asarray(a).astype(jd), jnp.asarray(w).astype(jd).T, preferred_element_type=jnp.float32)
    if epilogue == "store_f32":
        return acc
    if epilogue == "store":
        return acc.astype(jd)
    acc = acc + jnp.asarray(bias)
    if epilogue == "bias":
        return acc.astype(jd)
    if epilogue == "bias_gelu":
        return _gelu_exact(acc).astype(jd)
    rows = lambda t: jnp.repeat(jnp.asarray(t), L, axis=0)
    return jnp.asarray(resid).astype(jd).astype(jnp.float32) + (rows(fs) + 1.0) * acc + rows(fb)


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0**-5 * max(1.0, np.abs(ref).max())


def _inputs(seed, M, N, K, L, groups):
    a = [_normal(seed + i, M, K) for i in range(groups)]
    w = [_normal(seed + 10 + i, N, K, scale=K**-0.5) for i in range(groups)]
    return (a, w, _normal(seed + 20, N, scale=0.1), _normal(seed + 21, M, N),
            _normal(seed + 22, M // L, N, scale=0.1), _normal(seed + 23, M // L, N, scale=0.1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", list(g.EPILOGUES))
@pytest.mark.parametrize("M, N, K, L", SHAPES)
def test_gemm_matches_jax(dtype, epilogue, M, N, K, L):
    jd, td = DTYPES[dtype]
    (a,), (w,), bias, resid, fs, fb = _inputs(0, M, N, K, L, 1)
    t = lambda x: torch.from_numpy(x).to(td)
    before = g.gemm.launches
    out = g.gemm(t(a), t(w), epilogue, torch.from_numpy(bias), t(resid), torch.from_numpy(fs),
                 torch.from_numpy(fb), L)
    assert g.gemm.launches == before  # the plain path does not count
    assert out.dtype == (torch.float32 if epilogue in g.F32_OUT else td)
    _check(out, _jax_ref(a, w, epilogue, bias, resid, fs, fb, L, jd), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("groups", [2, 3])
def test_grouped_gemm_matches_jax(dtype, groups):
    """The grouped form (K1's q/k/v): one output per (a, w) pair."""
    jd, td = DTYPES[dtype]
    a, w, *_ = _inputs(1, 154, 48, 64, 1, groups)
    outs = g.gemm([torch.from_numpy(x).to(td) for x in a], [torch.from_numpy(x).to(td) for x in w])
    assert len(outs) == groups
    for out, ai, wi in zip(outs, a, w):
        _check(out, _jax_ref(ai, wi, "store", None, None, None, None, 1, jd), dtype)
