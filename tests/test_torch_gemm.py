"""The products of the port's kernels alone (`tcdiff_torch/ops/gemm.py`:
the forward projection K1, K2 and the other kernels run, and the
backward's input and weight gradients of K3-K5) against the products and
epilogues of the JAX package's Pallas kernels, written as those kernels
write them: `jnp.dot(..., preferred_element_type=f32)`, the bias in f32,
`_gelu_exact`, the FiLM residual of `_ff_tail_kernel`, `_lnmm_kernel`'s
product rounded before its bias, the backward's `dot_general`s of
`_ff_train_bwd_kernel`.

On the CPU the port's wrapper runs its plain version. Same seeded numpy
inputs into both; ragged shapes (M = 1, 154; N = 50 and K = 100, not
multiples of 8). Tolerances: f32 1e-5 abs/rel (the order of f32 sums);
bf16 2^-5 of the largest reference value, the bound the CUDA kernels are
held to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.ops.fused_ff_block import _gelu_exact  # noqa: E402
from tcdiff_torch.ops import gemm as g  # noqa: E402
from tcdiff_torch.ops.train_common import weight_splits  # noqa: E402

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
    if epilogue == "bias_rounded":  # _lnmm_kernel: the product rounded to T, then the bias added in T
        return acc.astype(jd) + jnp.asarray(bias).astype(jd)
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


# ------------------------------------------------------------------ backward
# The backward's products as `_ff_train_bwd_kernel`
# (tcdiff_tpu/ops/fused_ff_block_train.py) writes them, with the JAX
# package's weights stored (in, out): the input gradient
# dot_general(gc, w, (((1,), (1,)), ((), ()))) and the weight gradient
# dot_general(xc, gc, (((0,), (0,)), ((), ()))), f32 sums of operands in the
# compute dtype. The port's weight (out, in) is w^T, its weight gradient
# the transpose of the JAX one. Ragged shapes: R = 1, 200 (not a multiple
# of the 64-row K step), N = 49, K = 100.
BWD_SHAPES = [(200, 48, 64), (1, 49, 100), (200, 49, 100)]  # (M or R, N, K)


def _dg(x, y, dims, jd):
    return jax.lax.dot_general(jnp.asarray(x).astype(jd), jnp.asarray(y).astype(jd), (dims, ((), ())),
                               preferred_element_type=jnp.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", list(g.NN_EPILOGUES))
@pytest.mark.parametrize("M, N, K", BWD_SHAPES)
def test_gemm_nn_matches_jax(dtype, epilogue, M, N, K):
    """dy = g . W (W (out=K, in=N), nn.Linear layout) as dot_general(gc, w)."""
    jd, td = DTYPES[dtype]
    gc, w = _normal(30, M, K), _normal(31, N, K, scale=K**-0.5)  # w: the JAX weight (in, out)
    acc = _normal(32, M, N)
    before = g.gemm_nn.launches
    out = g.gemm_nn(torch.from_numpy(gc).to(td), torch.from_numpy(w.T.copy()).to(td), epilogue,
                    torch.from_numpy(acc.copy()))
    assert g.gemm_nn.launches == before
    ref = _dg(gc, w, ((1,), (1,)), jd)
    if epilogue == "acc_f32":
        ref = ref + acc
    assert out.dtype == (td if epilogue == "store" else torch.float32)
    _check(out, ref.astype(jd) if epilogue == "store" else ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemm_nn_joined_matches_jax(dtype):
    """The joined form, K3's dr = dq . Wq + dk . Wk: one f32 sum."""
    jd, td = DTYPES[dtype]
    M, N, K = 154, 48, 64
    a = [_normal(40 + i, M, K) for i in range(2)]
    w = [_normal(42 + i, N, K, scale=K**-0.5) for i in range(2)]
    out = g.gemm_nn([torch.from_numpy(x).to(td) for x in a], [torch.from_numpy(x.T.copy()).to(td) for x in w],
                    "store_f32")
    _check(out, _dg(a[0], w[0], ((1,), (1,)), jd) + _dg(a[1], w[1], ((1,), (1,)), jd), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R, N, K", BWD_SHAPES)
def test_wgrad_matches_jax(dtype, R, N, K):
    """dW = g^T . x (out, in) as the transpose of dot_general(xc, gc) over
    the rows, rounded to the compute dtype after the f32 sum."""
    jd, td = DTYPES[dtype]
    gc, x = _normal(50, R, N), _normal(51, R, K)
    before = g.wgrad.launches
    out = g.wgrad(torch.from_numpy(gc).to(td), torch.from_numpy(x).to(td))
    assert g.wgrad.launches == before
    assert out.dtype == td and tuple(out.shape) == (N, K)
    _check(out, _dg(x, gc, ((0,), (0,)), jd).T.astype(jd), dtype)


@pytest.mark.parametrize("rows, n, k, splits", [(28800, 512, 512, 16), (28800, 512, 1024, 8), (28800, 1024, 512, 8),
                                                 (9728, 512, 512, 16), (200, 512, 512, 4), (1, 49, 100, 1),
                                                 (1200, 128, 128, 19)])
def test_weight_splits(rows, n, k, splits):
    """The train kernels' row chunks: about one wave of 264 blocks (2 an
    SM) over the gradient's 128 x 128 tiles, each chunk a multiple of 64
    rows that together cover the rows."""
    assert weight_splits(rows, n, k) == splits
    chunk = -(-rows // splits)
    chunk = -(-chunk // 64) * 64
    assert (splits - 1) * chunk < rows <= splits * chunk
