"""The bodies K4 and K7 run on the card, exposed alone: their plain
versions (what a CPU tensor runs) against the JAX package, or against
autograd of the plain chain they differentiate.

- `gemm.gemm_nn_rot`, K4's memory cotangent dmem = rot_m^T(dk . Wk) + dv . Wv,
  against the JAX kernel's own arithmetic (`_ca_bwd_projm_kernel`'s: f32
  products, `_rot_t` of the first, then the sum rounded once), run in a
  Pallas program in interpret mode (the lane roll of `_rot_t` exists only
  inside a Pallas kernel), at a ragged memory length (Lm = 7, and a batch
  whose rows the tables repeat over);
- `gemm.gemm_lnrot`, K7's q projection with the LayerNorm and the rotary in
  its prologue, against `fused_ln_rotary_matmul(..., w_plain=None)` in
  interpret mode, as the JAX package's tests run it on the CPU;
- `gemm.wgrad` of a list (K4's dWk and dWv in one launch): one gradient
  each, against the JAX kernel's dot_general over the rows;
- the train row kernels' plain versions (`train_common.chain_top_bwd_plain`,
  `rows_bwd_plain`, written out by hand as the kernels compute them)
  against autograd of the plain chains they differentiate, at rate 0 and
  0.1 with the same seeds.

Tolerances: f32 1e-5 abs + 1e-5 rel (the order of f32 sums); bf16 2^-5 of
the largest reference value, the bound the CUDA kernels are held to (a
value rounded to bf16 on the other side of a tie moves an output by an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tcdiff_tpu.models.rotary import rotary_freqs  # noqa: E402
from tcdiff_tpu.ops.fused_ln_rotary_matmul import _tables, fused_ln_rotary_matmul  # noqa: E402
from tcdiff_tpu.ops.fused_sa_block_train import _rot_t  # noqa: E402
from tcdiff_torch.ops import gemm as g  # noqa: E402
from tcdiff_torch.ops import train_common as tc  # noqa: E402
from tcdiff_torch.ops.sa_block import rotary_tables  # noqa: E402
from tcdiff_torch.ops.sa_block_train import rot  # noqa: E402
from tcdiff_torch.ops.train_common import weight_splits  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, LM, D, HD = 3, 7, 64, 48
SEEDS = np.array([0x12345678, 0xDEADBEEF], dtype=np.uint32)  # one above 2^31


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _check(out, ref, dtype):
    out = out.detach().float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0**-5 * max(1.0, np.abs(ref).max())


# ------------------------------------------------------ K4's memory cotangent
def _jax_dmem(dk, wk, dv, wv, cos, ssin):
    """dmem per batch element as `_ca_bwd_projm_kernel` computes it: drm =
    dk . wk (wk stored (d, hd), as the JAX kernels take it) in f32,
    _rot_t(drm) + dv . wv in f32, rounded to the compute dtype once."""
    b, lm, hd = dk.shape
    d = wk.shape[0]
    nt = (((1,), (1,)), ((), ()))

    def kernel(dk_ref, wk_ref, dv_ref, wv_ref, c_ref, s_ref, o_ref):
        drm = jax.lax.dot_general(dk_ref[0], wk_ref[:], nt, preferred_element_type=jnp.float32)
        dvm = jax.lax.dot_general(dv_ref[0], wv_ref[:], nt, preferred_element_type=jnp.float32)
        o_ref[0] = (_rot_t(drm, c_ref[:].astype(jnp.float32), s_ref[:].astype(jnp.float32)) + dvm).astype(o_ref.dtype)

    rows = pl.BlockSpec((1, lm, hd), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    whole = lambda *shape: pl.BlockSpec(shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel, grid=(b,), in_specs=[rows, whole(d, hd), rows, whole(d, hd), whole(lm, d), whole(lm, d)],
        out_specs=pl.BlockSpec((1, lm, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, lm, d), dk.dtype), interpret=True,
    )(dk, wk, dv, wv, cos, ssin)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lm", [LM, 16])
def test_gemm_nn_rot_matches_jax(dtype, lm):
    jd, td = DTYPES[dtype]
    dk, dv = _normal(0, B, lm, HD), _normal(1, B, lm, HD)
    wk, wv = _normal(2, HD, D, scale=HD**-0.5), _normal(3, HD, D, scale=HD**-0.5)  # the port's (hd, d)
    angles = rotary_freqs(lm, D)
    cos, ssin = _tables(jnp.zeros((), jd), jnp.asarray(angles), D)
    ref = _jax_dmem(jnp.asarray(dk).astype(jd), jnp.asarray(wk.T).astype(jd), jnp.asarray(dv).astype(jd),
                    jnp.asarray(wv.T).astype(jd), cos, ssin)
    t = lambda x: torch.from_numpy(x).to(td)
    before = g.gemm_nn_rot.launches
    out = g.gemm_nn_rot(t(dk).flatten(0, 1), t(wk), t(dv).flatten(0, 1), t(wv), torch.from_numpy(angles))
    assert g.gemm_nn_rot.launches == before  # the plain path does not count
    assert out.dtype == td
    _check(out.view(B, lm, D), ref, dtype)


# ------------------------------------------------------------------- K7's q
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("length, d", [(24, D), (37, 96)])
def test_gemm_lnrot_matches_jax(dtype, length, d):
    """rot(LN(x)) . W^T as `fused_ln_rotary_matmul` in its rot-only form."""
    jd, td = DTYPES[dtype]
    x = 2.0 * _normal(4, 2, length, d) + 0.5
    s, b = 1.0 + _normal(5, d, scale=0.1), _normal(6, d, scale=0.1)
    w = _normal(7, HD, d, scale=d**-0.5)  # the port's (N, d)
    angles = rotary_freqs(length, d)
    ref = fused_ln_rotary_matmul(jnp.asarray(x).astype(jd), jnp.asarray(s), jnp.asarray(b), jnp.asarray(angles),
                                 jnp.asarray(w.T).astype(jd), None, eps=1e-5)
    before = g.gemm_lnrot.launches
    out = g.gemm_lnrot(torch.from_numpy(x).to(td), torch.from_numpy(s), torch.from_numpy(b),
                       torch.from_numpy(angles), torch.from_numpy(w).to(td), 1e-5)
    assert g.gemm_lnrot.launches == before
    assert out.dtype == td
    _check(out, ref, dtype)


# ------------------------------------------------------ grouped weight gradient
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_wgrad_matches_jax(dtype):
    """K4's dWk and dWv in one call: a list of gradients, each g^T . x over
    the rows as the transpose of dot_general(xc, gc), rounded after the
    f32 sum."""
    jd, td = DTYPES[dtype]
    gs = [_normal(10 + i, 200, HD) for i in range(2)]
    xs = [_normal(12 + i, 200, D) for i in range(2)]
    outs = g.wgrad([torch.from_numpy(a).to(td) for a in gs], [torch.from_numpy(a).to(td) for a in xs])
    assert len(outs) == 2
    for out, gc, x in zip(outs, gs, xs):
        ref = jax.lax.dot_general(jnp.asarray(x).astype(jd), jnp.asarray(gc).astype(jd), (((0,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        assert out.dtype == td
        _check(out, ref.T.astype(jd), dtype)


@pytest.mark.parametrize("rows, n, k, groups, splits", [(9728, 512, 512, 2, 8), (28800, 512, 512, 2, 8),
                                                         (200, 48, 64, 2, 4), (9728, 512, 512, 1, 16)])
def test_grouped_weight_splits(rows, n, k, groups, splits):
    """A grouped weight gradient's row chunks: about one wave of 264
    blocks over all its gradients' tiles together."""
    assert weight_splits(rows, n, k, groups) == splits
    assert tc.weight_scratch((rows, n, k, groups)) == groups * splits * n * k


# ----------------------------------------------------------- train row kernels
def _chain_inputs(seed, b=2, length=9, d=D):
    """z (or dr), x, the LayerNorm affine, the FiLM rows and the seeds."""
    t = lambda i, *shape, scale=1.0: torch.from_numpy(_normal(seed + i, *shape, scale=scale))
    return (t(0, b, length, d), t(1, b, length, d), 1.0 + t(2, d, scale=0.1), t(3, d, scale=0.1),
            t(4, b, d, scale=0.1), t(5, b, d, scale=0.1), torch.from_numpy(SEEDS[:b].astype(np.int64)))


def _close(a, b, what):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_chain_top_bwd_plain_matches_autograd(rate):
    """The chain top's backward, written out (dz, dfs, dfb, ds, db), against
    autograd of its forward x + (fs+1) * drop_OUT(LN(drop_FC(z))) + fb."""
    z, x, s, b, fs, fb, seeds = _chain_inputs(20)
    leaves = [t.clone().requires_grad_() for t in (z, s, b, fs, fb)]
    out = tc.chain_top_fwd(leaves[0], x, *leaves[1:], seeds, rate=rate)
    cot = torch.from_numpy(_normal(30, *out.shape))
    auto = torch.autograd.grad(out, leaves, cot)
    dz, dfs, dfb, ds, db = tc.chain_top_bwd(cot, z, s, b, fs, seeds, rate=rate)
    for what, mine, ref in (("dz", dz, auto[0]), ("ds", ds, auto[1]), ("db", db, auto[2]), ("dfs", dfs, auto[3]),
                            ("dfb", dfb, auto[4])):
        assert mine.shape == ref.shape, what
        _close(mine, ref, what)
    assert torch.equal(out, tc.chain_top_fwd_plain(z, x, s, b, fs, fb, seeds, rate=rate))


# (rotary, dadd, LayerNorm, residual): K3's (all four), K4's x side (no
# dadd), K4's f32 memory side (rotary and dadd only), K5's (LayerNorm and an
# f32 residual)
ROWS_CASES = {"K3": (True, True, True, True), "K4_x": (True, False, True, True),
              "K4_mem": (True, True, False, False), "K5": (False, False, True, True)}


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_rows_bwd_plain_matches_autograd(case):
    """The bottom of a block's backward, written out, against autograd of
    f(x, s, b) = <rot(y), dr> + <y, dadd> + <x, resid>, y = LN(x) * s + b
    (y = x without the LayerNorm): dx, and ds, db summed over the rows."""
    use_rot, use_dadd, use_ln, use_res = ROWS_CASES[case]
    dr, x, s, bias, _, _, _ = _chain_inputs(40)
    dadd = torch.from_numpy(_normal(50, *dr.shape)) if use_dadd else None
    resid = torch.from_numpy(_normal(51, *dr.shape)) if use_res else None
    angles = torch.from_numpy(rotary_freqs(dr.shape[1], D)) if use_rot else None
    leaves = [t.clone().requires_grad_() for t in (x, s, bias)]
    xl, sl, bl = leaves
    if use_ln:
        mu = xl.mean(-1, keepdim=True)
        y = (xl - mu) * torch.rsqrt((xl * xl).mean(-1, keepdim=True) - mu * mu + 1e-5) * sl + bl
    else:
        y = xl
    f = (rot(y, *rotary_tables(angles, torch.float32)) * dr).sum() if use_rot else (y * dr).sum()
    if use_dadd:
        f = f + (y * dadd).sum()
    if use_res:
        f = f + (xl * resid).sum()
    auto = torch.autograd.grad(f, leaves, allow_unused=True)
    out, ds, db = tc.rows_bwd(dr, x if use_ln else None, s if use_ln else None, 1e-5, angles=angles, dadd=dadd,
                              resid=resid, dtype=torch.float32)
    _close(out, auto[0], "dx")
    if use_ln:
        _close(ds, auto[1], "ds")
        _close(db, auto[2], "db")
    else:
        assert ds is None and db is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_plain_versions_round_where_the_kernels_do(dtype):
    """In the compute dtype the plain versions round only their outputs:
    dz and the row output are the f32 result rounded once."""
    z, x, s, b, fs, fb, seeds = _chain_inputs(60)
    g32 = torch.from_numpy(_normal(61, *z.shape))
    dz, *_ = tc.chain_top_bwd(g32.to(dtype), z, s, b, fs, seeds, rate=0.1)
    dz32, *_ = tc.chain_top_bwd(g32.to(dtype).float(), z, s, b, fs, seeds, rate=0.1)
    assert dz.dtype == dtype and torch.equal(dz, dz32.to(dtype))
    out, _, _ = tc.rows_bwd(z, x.to(dtype), s, angles=torch.from_numpy(rotary_freqs(z.shape[1], D)))
    assert out.dtype == dtype


def test_new_bodies_refuse_a_device_that_is_neither_cpu_nor_cuda():
    """A tensor on another device never falls back to the plain version."""
    meta = lambda *s: torch.empty(s, device="meta")
    x, v, f, sd = meta(2, 8, D), meta(D), meta(2, D), meta(2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        g.gemm_nn_rot(meta(16, HD), meta(HD, D), meta(16, HD), meta(HD, D), meta(8, D))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        g.gemm_lnrot(x, v, v, meta(8, D), meta(HD, D))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tc.chain_top_fwd(x, x, v, v, f, f, sd, rate=0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tc.chain_top_bwd(x, x, v, v, f, sd, rate=0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tc.rows_bwd(x, x, v)
