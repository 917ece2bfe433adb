"""The wgmma + TMA body of the port's bf16 forward projection and the
kernels redesigned around it, K2b, K8 and K9, on the CPU.

- `gemm.gemm_plan`, the dispatch rule of the body written out (which body
  runs a product, its tile, grid and waves, by shape and by alignment), at
  the serving shapes and at the shapes it sends to mma.sync, and
  `gemm.tma_ok` on tensors one or more elements off a 16-byte boundary;
- `gemm.gemm_wg`'s plain version (the grouped form with an N per product,
  every epilogue) against the products and epilogues of the JAX package's
  Pallas kernels (`jnp.dot(..., preferred_element_type=f32)`, the bias in
  f32, `_gelu_exact`, `_ff_kernel`'s FiLM residual, `_lnmm_kernel`'s
  product rounded before its bias);
- the rounded-bias epilogue of `gemm_plain` (K9's product) bit for bit
  against `ln_matmul_plain`'s rounding, and apart from the plain bias;
- K8 with its rotated weights apart (q and k, as the per-op call site
  passes them) against `fused_ln_rotary_matmul` with the joined weight in
  interpret mode, as `tests/test_torch_serving_ops.py` runs it, at
  d = 64 and at other widths; K2b against `fused_ff_block` at widths other
  than `tests/test_torch_block_ops.py`'s.

Same seeded numpy inputs into both; tolerances f32 1e-5 abs/rel (the order
of f32 sums), bf16 2^-5 of the largest reference value, the bound the CUDA
kernels are held to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.models.rotary import rotary_freqs  # noqa: E402
from tcdiff_tpu.ops.fused_ff_block import _gelu_exact, fused_ff_block  # noqa: E402
from tcdiff_tpu.ops.fused_ln_rotary_matmul import fused_ln_rotary_matmul  # noqa: E402
from tcdiff_torch.ops import ff_block, ln_rotary_matmul  # noqa: E402
from tcdiff_torch.ops import gemm as g  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0**-5 * max(1.0, np.abs(ref).max())


# ------------------------------------------------------------ the dispatch
# (M, the products' N, K, TMA takes every A and W, the epilogue's operands
# 16-byte aligned) -> (body, launches, grid). The serving shapes (M = b L =
# 3600): K8's q, k, v (with a joined [w_q; w_k] too) and its rot-only
# form, K2b's W1 (N = ff = 1024) and W2 (K = 1024), K9's linear1 (N =
# 1024: 232 blocks, 1.76 waves) and linear3 (N = 512: 116 blocks, 0.88
# waves); a narrow N = 40 on wgmma; then what sends a product to mma.sync:
# an operand TMA cannot take, K % 8 != 0, an N % 8 != 0 (in any product of
# the group), an epilogue operand off 16 bytes.
PLANS = [
    ((3600, [512, 512, 512], 512, True, True), ("wgmma", 1, (12, 29))),
    ((3600, [1024, 512], 512, True, True), ("wgmma", 1, (12, 29))),
    ((3600, [512], 512, True, True), ("wgmma", 1, (4, 29))),
    ((3600, [1024], 512, True, True), ("wgmma", 1, (8, 29))),
    ((3600, [512], 1024, True, True), ("wgmma", 1, (4, 29))),
    ((3600, [1536], 512, True, True), ("wgmma", 1, (12, 29))),
    ((3600, [96], 64, True, True), ("wgmma", 1, (1, 29))),
    ((154, [96, 200, 64], 64, True, True), ("wgmma", 1, (4, 2))),
    ((154, [40], 64, True, True), ("wgmma", 1, (1, 2))),
    ((450, [512, 512, 512], 512, True, True), ("wgmma", 1, (12, 4))),
    ((1, [512], 512, True, True), ("wgmma", 1, (4, 1))),
    ((3600, [512], 512, False, True), ("mma.sync", 1, (4, 29))),
    ((3600, [512, 512, 512], 512, False, True), ("mma.sync", 3, (12, 29))),
    ((154, [48], 100, True, True), ("mma.sync", 1, (1, 2))),
    ((154, [50], 64, True, True), ("mma.sync", 1, (1, 2))),
    ((154, [49], 64, True, True), ("mma.sync", 1, (1, 2))),
    ((3600, [512, 50], 512, True, True), ("mma.sync", 2, (5, 29))),
    ((3600, [512], 512, True, False), ("mma.sync", 1, (4, 29))),
    ((3600, [1024], 512, True, False), ("mma.sync", 1, (8, 29))),
    # every K1/K2 product of the cell sample.g3.b128 (256 rows x 450 tokens
    # = 115,200, d 512, 8 x 64 heads, ff 1024): K1's q/k/v (one launch) and
    # fc with its post-LN (a fold; K7's fc the same), K2's W1, W2 with LN4
    # (a fold) and W3
    ((115200, [512, 512, 512], 512, True, True), ("wgmma", 1, (12, 900))),
    ((115200, [512], 512, True, True, True), ("wgmma", 1, (4, 900))),
    ((115200, [1024], 512, True, True), ("wgmma", 1, (8, 900))),
    ((115200, [512], 1024, True, True, True), ("wgmma", 1, (4, 900))),
    ((115200, [512], 512, True, True), ("wgmma", 1, (4, 900))),
    # folds the wgmma body does not take (gemm_ln's, one launch): a row
    # past a cluster, an operand off its alignment, N % 8 != 0
    ((3600, [1152], 512, True, True, True), ("mma.sync", 1, (9, 29))),
    ((3600, [512], 512, False, True, True), ("mma.sync", 1, (4, 29))),
    ((3600, [512], 512, True, False, True), ("mma.sync", 1, (4, 29))),
    ((3600, [500], 512, True, True, True), ("mma.sync", 1, (4, 29))),
]


@pytest.mark.parametrize("args, want", PLANS)
def test_gemm_plan(args, want):
    """Which body runs a bf16 projection or LayerNorm fold (a sixth arg of
    True), in how many launches, and its grid: the rule csrc/gemm_wgmma.cuh
    applies (gemm_wg, wg_ok; gemm_ln_wg, ln_wg_ok)."""
    M, ns, K, tma, epi_aligned, *fold = args
    p = g.gemm_plan(M, ns, K, tma=tma, epilogue_aligned=epi_aligned, ln_fold=bool(fold))
    assert (p["body"], p["launches"], p["grid"]) == want
    assert p["tile"] == (128, 128) and p["blocks"] == p["grid"][0] * p["grid"][1]
    assert p["waves"] == pytest.approx(p["blocks"] / (g.SMS * (1 if p["body"] == "wgmma" else 2)))


def test_gemm_plan_takes_one_product_a_fold():
    with pytest.raises(ValueError):
        g.gemm_plan(3600, [512, 512], 512, ln_fold=True)


@pytest.mark.parametrize("form", ["post", "post with FiLM", "film_pre", "post then LN2",
                                  "post with FiLM then LN2 and rotary"])
def test_gemm_ln_plain_is_the_unfused_sequence(form):
    """gemm_ln_plain, the oracle of the bf16 fold, is the f32 blocks' unfused
    sequence (fc_post_ln, ff_out of csrc/blocks.cuh) written with its parts'
    plain versions: the product in f32 (gemm_plain store_f32, or bias_film
    for LN4's input), the row body (ln_rows_plain) with the FiLM rows, and
    the next LayerNorm (and rotary) on the rounded output; bit for bit in
    bf16."""
    from tcdiff_torch.models.rotary import angle_table
    from tcdiff_torch.ops.layernorm import ln_rows_plain

    bf = torch.bfloat16
    rng = lambda seed, *s, sc=1.0: torch.from_numpy(_normal(seed, *s, scale=sc))
    B, L, N, K = 3, 4, 16, 24
    M = B * L
    a, w = rng(0, M, K).to(bf), rng(1, N, K, sc=K**-0.5).to(bf)
    s, b, pb = 1 + rng(2, N, sc=0.1), rng(3, N, sc=0.1), rng(4, N, sc=0.1)
    resid, fs, fb = rng(5, M, N).to(bf), rng(6, B, N, sc=0.1), rng(7, B, N, sc=0.1)
    film = "FiLM" in form or form == "film_pre"
    if form == "film_pre":
        z = g.gemm_plain(a, w, "bias_film", pb, resid, fs, fb, L)
        out = g.gemm_ln_plain(a, w, s, b, 1e-5, "film_pre", pb, resid, fs, fb, L)
        want, _ = ln_rows_plain(z.view(B, L, N), s, b, 1e-5, dtype=bf)
    else:
        z = g.gemm_plain(a, w, "store_f32")
        kw = dict(film_scale=fs, film_shift=fb, resid=resid.view(B, L, N)) if film else {}
        want, _ = ln_rows_plain(z.view(B, L, N), s, b, 1e-6, dtype=bf, **kw)
        nxt = None
        if "LN2" in form:
            ang = angle_table(L, N, "cpu") if "rotary" in form else None
            nxt = (1 + rng(8, N, sc=0.1), rng(9, N, sc=0.1), 1e-5, ang)
            n_out, n_rot = ln_rows_plain(want, *nxt[:3], angles=ang, normed=ang is None)
            want = (want, n_out if ang is None else n_rot)
        out = g.gemm_ln_plain(a, w, s, b, 1e-6, "post", None, resid if film else None, fs if film else None,
                              fb if film else None, L, nxt)
    outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    assert len(outs) == len(wants)
    for o, ww in zip(outs, wants):
        assert torch.equal(o, ww.reshape(M, N))


@pytest.mark.parametrize("offset", [0, 1, 4, 8])
@pytest.mark.parametrize("K", [64, 100])
def test_tma_ok_by_offset_and_row_stride(offset, K):
    """An operand TMA reads: its base on a 16-byte boundary (an offset of 0
    or 8 bf16 elements) and rows a multiple of 16 bytes apart (K % 8 ==
    0); the plan of a product over it follows."""
    buf = torch.zeros(16 * K + 8, dtype=torch.bfloat16)
    a = buf[offset:offset + 16 * K].view(16, K)
    want = offset % 8 == 0 and K % 8 == 0
    assert g.tma_ok(a) == want
    assert g.aligned16(a) == (offset % 8 == 0)
    assert g.gemm_plan(16, [64], K, tma=g.tma_ok(a))["body"] == ("wgmma" if want else "mma.sync")


BF, F32 = torch.bfloat16, torch.float32
# (dtype, dk, TRPE table, view offset in elements, Lq, rows, heads) ->
# (body, queries a block, keys a tile, grid); the plan does not depend on
# the keys
ATTN_PLANS = [
    # the serving cell's calls: 256 rows (CFG) and 128 (layer 0's dedup) at 450 x 450
    ((BF, 64, False, 0, 450, 256, 8), ("wgmma", 128, 128, (132, 1, 1))),
    ((BF, 64, False, 0, 450, 128, 8), ("wgmma", 128, 128, (132, 1, 1))),
    # the train forward of K3 and K4 (600 x 600 and 600 x 152) at the train cell's 600 tokens
    ((BF, 64, False, 0, 600, 256, 8), ("wgmma", 128, 128, (132, 1, 1))),
    # one query a row: a tile for each (row, head)
    ((BF, 64, False, 0, 1, 2, 8), ("wgmma", 128, 128, (16, 1, 1))),
    # fewer tiles than SMs: a block a tile
    ((BF, 64, False, 0, 450, 2, 3), ("wgmma", 128, 128, (24, 1, 1))),
    # the mma.sync body's: the TRPE bias, other head widths, a view one element off
    ((BF, 64, True, 0, 450, 8, 8), ("mma.sync", 64, 64, (8, 8, 8))),
    ((BF, 20, False, 0, 450, 8, 8), ("mma.sync", 64, 64, (8, 8, 8))),
    ((BF, 32, False, 0, 450, 8, 8), ("mma.sync", 64, 64, (8, 8, 8))),
    ((BF, 64, False, 1, 450, 8, 8), ("mma.sync", 64, 64, (8, 8, 8))),
    # f32: the FMA body
    ((F32, 64, False, 0, 450, 8, 8), ("fma", 64, 32, (8, 8, 8))),
]


@pytest.mark.parametrize("args, want", ATTN_PLANS)
def test_attention_plan(args, want):
    """Which body runs an attention call, its tiles and grid: the rule of
    csrc/attention.cuh (attn_plan) written out in ops/attention, with the
    alignment read from a (b, h, L, dk) view of (b, L, h*dk) projections
    `offset` elements past a 16-byte boundary."""
    from tcdiff_torch.ops import attention as m

    dtype, dk, trpe, offset, lq, rows, heads = args
    buf = torch.zeros(2 * 5 * 3 * dk + 8, dtype=dtype)
    view = buf[offset:offset + 2 * 5 * 3 * dk].view(2, 5, 3, dk).transpose(1, 2)
    aligned = m.tma_aligned(view)
    assert aligned == (offset == 0 and dk % 8 == 0)
    p = m.attention_plan(dtype, dk, trpe, aligned, lq, rows, heads)
    assert (p["body"], p["q_block"], p["k_tile"], p["grid"]) == want


def _jax_ref(a, w, epilogue, bias, resid, fs, fb, L, jd):
    """The Pallas kernels' product and epilogue: a . w^T in f32 sums."""
    acc = jnp.dot(jnp.asarray(a).astype(jd), jnp.asarray(w).astype(jd).T, preferred_element_type=jnp.float32)
    if epilogue in ("store", "store_f32"):
        return acc.astype(jd) if epilogue == "store" else acc
    if epilogue == "bias_rounded":  # _lnmm_kernel: the product rounded to T, then the bias added in T
        return acc.astype(jd) + jnp.asarray(bias).astype(jd)
    acc = acc + jnp.asarray(bias)
    if epilogue in ("bias", "bias_gelu"):
        return (acc if epilogue == "bias" else _gelu_exact(acc)).astype(jd)
    rows = lambda t: jnp.repeat(jnp.asarray(t), L, axis=0)
    acc = jnp.asarray(resid).astype(jd).astype(jnp.float32) + (rows(fs) + 1.0) * acc + rows(fb)
    return acc if epilogue == "bias_film" else acc.astype(jd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", list(g.WG_EPILOGUES))
def test_gemm_wg_matches_jax(dtype, epilogue):
    """One product (M = 154 over rows of L = 77, N = 50, K = 64) with each
    epilogue; bias_film_t is `_ff_kernel`'s FiLM residual rounded once."""
    jd, td = DTYPES[dtype]
    M, N, K, L = 154, 50, 64, 77
    a, w = _normal(0, M, K), _normal(1, N, K, scale=K**-0.5)
    bias, resid, fs, fb = _normal(2, N, scale=0.1), _normal(3, M, N), _normal(4, 2, N, scale=0.1), _normal(5, 2, N)
    t = lambda x: torch.from_numpy(x).to(td)
    before = g.gemm_wg.launches
    out = g.gemm_wg(t(a), t(w), epilogue, torch.from_numpy(bias), t(resid), torch.from_numpy(fs),
                    torch.from_numpy(fb), L)
    assert g.gemm_wg.launches == before  # the plain path does not count
    assert out.dtype == (torch.float32 if epilogue in g.F32_OUT else td)
    _check(out, _jax_ref(a, w, epilogue, bias, resid, fs, fb, L, jd), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemm_plain_bias_rounded_is_ln_matmul_rounding(dtype):
    """gemm_plain(..., "bias_rounded") on T(LN(x)) is ln_matmul_plain bit for
    bit: the product rounded to T, then the bias added in T. With a bias of
    ~8, in bf16 that is not the plain bias epilogue's T(acc + bias)."""
    from tcdiff_torch.ops._common import ln_f32
    from tcdiff_torch.ops.ln_matmul import ln_matmul_plain

    td = DTYPES[dtype][1]
    d, n = 64, 40
    x = torch.from_numpy(_normal(50, 3, 20, d)).to(td)
    s, b = torch.from_numpy(1.0 + 0.1 * _normal(51, d)), torch.from_numpy(0.1 * _normal(52, d))
    w, bias = torch.from_numpy(_normal(53, n, d, scale=d**-0.5)).to(td), torch.from_numpy(_normal(54, n, scale=8.0))
    y = ln_f32(x, s, b, 1e-5).to(td).view(-1, d)
    out = g.gemm_plain(y, w, "bias_rounded", bias)
    assert out.dtype == td
    assert torch.equal(out, ln_matmul_plain(x, s, b, w, bias).view(-1, n))
    if td == torch.bfloat16:
        assert not torch.equal(out, g.gemm_plain(y, w, "bias", bias))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shared_a", [True, False])
def test_gemm_wg_groups_of_their_own_n(dtype, shared_a):
    """The grouped form: up to three products with unequal N, over one a
    or one a each."""
    jd, td = DTYPES[dtype]
    M, K, ns = 154, 64, (96, 200, 8)
    a = [_normal(10 + i, M, K) for i in range(3)]
    w = [_normal(20 + i, n, K, scale=K**-0.5) for i, n in enumerate(ns)]
    ta = torch.from_numpy(a[0]).to(td) if shared_a else [torch.from_numpy(x).to(td) for x in a]
    outs = g.gemm_wg(ta, [torch.from_numpy(x).to(td) for x in w])
    assert [tuple(o.shape) for o in outs] == [(M, n) for n in ns]
    for i, (out, wi) in enumerate(zip(outs, w)):
        _check(out, _jax_ref(a[0] if shared_a else a[i], wi, "store", None, None, None, None, 1, jd), dtype)


# ------------------------------------------------------------------ K8, K2b
B, L, D, HD = 2, 24, 64, 48


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("plain", [True, False])
def test_ln_rotary_matmul_apart_matches_jax(dtype, plain):
    """K8 with q's and k's weights apart, as the per-op call site passes
    them: each rotated output is its half of the JAX kernel's joined q||k."""
    jd, td = DTYPES[dtype]
    x = _normal(6, B, L, D)
    s, b = (1.0 + 0.1 * _normal(7, D)), 0.1 * _normal(8, D)
    angles = rotary_freqs(L, D)
    wq, wk, wv = (_normal(9 + i, HD, D, scale=D**-0.5) for i in range(3))  # nn.Linear layout (out, in)
    jx = jnp.asarray(x).astype(jd)
    jargs = (jnp.asarray(s), jnp.asarray(b), jnp.asarray(angles))
    jr = jnp.asarray(np.concatenate([wq, wk]).T).astype(jd)  # the JAX weight (in, out), q||k joined
    t = lambda v: torch.from_numpy(v).to(td)
    targs = (t(x), torch.from_numpy(s), torch.from_numpy(b), torch.from_numpy(angles), (t(wq), t(wk)))
    before = ln_rotary_matmul.ln_rotary_matmul.launches
    if plain:
        ref_qk, ref_v = fused_ln_rotary_matmul(jx, *jargs, jr, jnp.asarray(wv.T).astype(jd), eps=1e-5)
        (q, k), v = ln_rotary_matmul.ln_rotary_matmul(*targs, t(wv), 1e-5)
        _check(v, ref_v, dtype)
    else:
        ref_qk = fused_ln_rotary_matmul(jx, *jargs, jr, None, eps=1e-5)
        q, k = ln_rotary_matmul.ln_rotary_matmul(*targs, None, 1e-5)
    assert ln_rotary_matmul.ln_rotary_matmul.launches == before
    _check(q, ref_qk[..., :HD], dtype)
    _check(k, ref_qk[..., HD:], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d, hd", [(128, 64), (96, 40)])
@pytest.mark.parametrize("plain", [True, False])
def test_ln_rotary_matmul_apart_widths_match_jax(dtype, d, hd, plain):
    """K8 with q's and k's weights apart at other widths: d = 128 with
    products of 64 columns, d = 96 with 40 (N % 8 == 0, whose products
    the card runs on wgmma, and K = 96)."""
    jd, td = DTYPES[dtype]
    x = _normal(30, B, L, d)
    s, b = (1.0 + 0.1 * _normal(31, d)), 0.1 * _normal(32, d)
    angles = rotary_freqs(L, d)
    wq, wk, wv = (_normal(33 + i, hd, d, scale=d**-0.5) for i in range(3))
    jx = jnp.asarray(x).astype(jd)
    jargs = (jnp.asarray(s), jnp.asarray(b), jnp.asarray(angles))
    jr = jnp.asarray(np.concatenate([wq, wk]).T).astype(jd)
    t = lambda v: torch.from_numpy(v).to(td)
    targs = (t(x), torch.from_numpy(s), torch.from_numpy(b), torch.from_numpy(angles), (t(wq), t(wk)))
    if plain:
        ref_qk, ref_v = fused_ln_rotary_matmul(jx, *jargs, jr, jnp.asarray(wv.T).astype(jd), eps=1e-5)
        (q, k), v = ln_rotary_matmul.ln_rotary_matmul(*targs, t(wv), 1e-5)
        _check(v, ref_v, dtype)
    else:
        ref_qk = fused_ln_rotary_matmul(jx, *jargs, jr, None, eps=1e-5)
        q, k = ln_rotary_matmul.ln_rotary_matmul(*targs, None, 1e-5)
    _check(q, ref_qk[..., :hd], dtype)
    _check(k, ref_qk[..., hd:], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("b, l, d, ff", [(2, 37, 128, 256), (1, 40, 96, 200)])
def test_ff_block_widths_match_jax(dtype, film, b, l, d, ff):
    """K2b (ff_block's plain version on the CPU) against `fused_ff_block` in
    interpret mode: rows no 128-row tile divides, and d = 96 with ff = 200."""
    jd, td = DTYPES[dtype]
    x = _normal(40, b, l, d)
    s3, b3 = 1.0 + 0.1 * _normal(41, d), 0.1 * _normal(42, d)
    w1, w2 = _normal(43, ff, d, scale=d**-0.5), _normal(44, d, ff, scale=ff**-0.5)  # nn.Linear layout
    bb1, bb2 = 0.1 * _normal(45, ff), 0.1 * _normal(46, d)
    fs, fb = (0.1 * _normal(47, b, d), 0.1 * _normal(48, b, d)) if film else (None, None)
    j = lambda v: None if v is None else jnp.asarray(v)
    jc = lambda v: jnp.asarray(v).astype(jd)
    ref = fused_ff_block(jc(x), j(s3), j(b3), jc(w1.T), j(bb1), jc(w2.T), j(bb2), j(fs), j(fb))
    t = lambda v: None if v is None else torch.from_numpy(v)
    tc = lambda v: torch.from_numpy(v).to(td)
    out = ff_block.ff_block(tc(x), t(s3), t(b3), tc(w1), t(bb1), tc(w2), t(bb2), t(fs), t(fb))
    _check(out, ref, dtype)
