"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips when no CUDA device is present (this runs
on a GPU machine: `python -m pytest tests/test_torch_cuda.py -q`). Small
shapes with the serving head width (dk=64). Tolerance: f32 1e-4 of the
output scale (the sums run in another order); bf16 4 bf16 ulps of the
largest output (q/k/v, attention weights and outputs are rounded to bf16).
"""

import copy
import time

import pytest

torch = pytest.importorskip("torch")

from tcdiff_torch.config import TrajDecoderConfig  # noqa: E402
from tcdiff_torch.models.rotary import angle_table  # noqa: E402
from tcdiff_torch.ops import ff_block, sa_block  # noqa: E402
from tcdiff_torch.trajdecoder import TrajDecoder  # noqa: E402

pytestmark = pytest.mark.cuda
B, L, D, H, FF = 2, 100, 128, 2, 256


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref):
    scale = max(1.0, ref.abs().max().item())
    return (2.0**-5 if dtype == torch.bfloat16 else 1e-4) * scale


def _rnd(gen, dev, *shape, std=1.0):
    return torch.randn(shape, generator=gen, device=dev) * std


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("trpe", [False, True])
def test_sa_block_kernel_matches_plain(dev, dtype, film, trpe):
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    x = r(B, L, D).to(dtype)
    ws = [r(o, i, std=i**-0.5).to(dtype) for o, i in ((128, D), (128, D), (128, D), (D, 128))]
    args = (x, 1 + r(D, std=0.1), r(D, std=0.1), angle_table(L, D, dev), *ws,
            1 + r(D, std=0.1), r(D, std=0.1),
            r(10, 128).to(dtype) if trpe else None,
            torch.randint(0, 12, (B, L, L), generator=g, device=dev) if trpe else None,
            r(B, D, std=0.1) if film else None, r(B, D, std=0.1) if film else None)
    before, bodies = sa_block.sa_block.launches, _attn_bodies("sa_block")
    out = sa_block.sa_block(*args, nhead=H)
    ref = sa_block.sa_block_plain(*args, nhead=H)
    assert sa_block.sa_block.launches == before + 1
    assert _bodies_since(bodies, "sa_block") == _ran(dtype, 128 // H, trpe, 1)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ff_tail_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    x = r(B, L, D).to(dtype)
    args = (x, 1 + r(D, std=0.1), r(D, std=0.1), r(FF, D, std=D**-0.5).to(dtype), r(FF, std=0.1),
            r(D, FF, std=FF**-0.5).to(dtype), r(D, std=0.1), r(B, D, std=0.1), r(B, D, std=0.1),
            1 + r(D, std=0.1), r(D, std=0.1), r(D, D, std=D**-0.5).to(dtype), r(D, std=0.1))
    before = ff_block.ff_tail.launches
    out = ff_block.ff_tail(*args)
    ref = ff_block.ff_tail_plain(*args)
    assert ff_block.ff_tail.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


# ---------------------------------------------------------------- projection
# The projection of csrc/gemm_mma.cuh through its entry point (ops/gemm.py):
# bf16 on the tensor cores, f32 on the FMA tiles. Ragged M (1, 154, 3600
# against 128-row tiles), an odd N (the epilogue element by element, not
# in pairs), K not a multiple of 8 (2-byte loads), each epilogue, and the
# grouped form, also with an operand that starts 2 bytes past a 16-byte
# boundary.

GEMM_L = {1: 1, 154: 77, 3600: 450}  # M -> L, the rows of one FiLM row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["store", "store_f32", "bias", "bias_gelu", "bias_film", "bias_rounded"])
@pytest.mark.parametrize("M", [1, 154, 3600])
@pytest.mark.parametrize("N, K", [(48, 64), (49, 64), (64, 100)])
def test_gemm_kernel_matches_plain(dev, dtype, epilogue, M, N, K):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(9)
    L = GEMM_L[M]
    a, w = _rnd(g, dev, M, K).to(dtype), _rnd(g, dev, N, K, std=K**-0.5).to(dtype)
    extra = (_rnd(g, dev, N, std=0.1), _rnd(g, dev, M, N).to(dtype), _rnd(g, dev, M // L, N, std=0.1),
             _rnd(g, dev, M // L, N, std=0.1), L)
    before = m.gemm.launches
    out = m.gemm(a, w, epilogue, *extra)
    ref = m.gemm_plain(a, w, epilogue, *extra)
    assert m.gemm.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == (M, N)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_grouped_gemm_kernel_matches_plain(dev, dtype, groups, offset):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(10)
    M, N, K = 154, 96, 64
    buf = _rnd(g, dev, groups * M * K + offset).to(dtype)
    a = [buf[offset + i * M * K: offset + (i + 1) * M * K].view(M, K) for i in range(groups)]
    w = [_rnd(g, dev, N, K, std=K**-0.5).to(dtype) for _ in range(groups)]
    before = m.gemm.launches
    outs = m.gemm(a, w)
    assert m.gemm.launches == before + 1 and len(outs) == groups
    for out, ref in zip(outs, m.gemm_plain(a, w)):
        assert out.dtype == dtype and out.shape == (M, N)
        assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


def test_gemm_refuses_what_it_does_not_take(dev):
    from tcdiff_torch.ops import gemm as m

    a, w = torch.zeros(8, 16, device=dev), torch.zeros(4, 16, device=dev)
    with pytest.raises(ValueError):
        m.gemm(a, w, "relu")
    with pytest.raises(ValueError):  # more than three triples
        m.gemm([a] * 4, [w] * 4)
    with pytest.raises(ValueError):  # the group does not share K
        m.gemm([a, a[:, :8].contiguous()], [w, w[:, :8].contiguous()])
    with pytest.raises(ValueError):  # bias missing
        m.gemm(a, w, "bias")
    with pytest.raises(TypeError):
        m.gemm(a.half(), w.half())


# ------------------------------------------------------- backward products
# The input gradient (gemm_nn, also joined over two pairs) and the split-row
# weight gradient (wgrad) of csrc/gemm_mma.cuh through ops/gemm.py: bf16 on
# the tensor cores, f32 on the FMA tiles. Rows M or R = 1, 200 and 1000
# (not multiples of the 64-row K step) and 28800 (the train rows); an odd N
# (the epilogue element by element), K % 8 != 0 (2-byte loads), operands
# 2 bytes past a 16-byte boundary, split counts given; each weight gradient
# twice, bit for bit.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["store", "store_f32", "acc_f32"])
@pytest.mark.parametrize("M", [1, 200, 28800])
@pytest.mark.parametrize("N, K", [(48, 64), (49, 64), (64, 100), (512, 512)])
def test_gemm_nn_kernel_matches_plain(dev, dtype, epilogue, M, N, K):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(11)
    a, b = _rnd(g, dev, M, K).to(dtype), _rnd(g, dev, K, N, std=K**-0.5).to(dtype)
    acc = _rnd(g, dev, M, N)
    before = m.gemm_nn.launches
    out = m.gemm_nn(a, b, epilogue, acc.clone())
    ref = m.gemm_nn_plain(a, b, epilogue, acc.clone())
    assert m.gemm_nn.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == (M, N)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


def _offset_views(gen, dev, dtype, n, shape, offset, std=1.0):
    """n contiguous views of one buffer, the first `offset` elements past its start."""
    size = shape[0] * shape[1]
    buf = _rnd(gen, dev, n * size + offset, std=std).to(dtype)
    return [buf[offset + i * size: offset + (i + 1) * size].view(*shape) for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("offset", [0, 1])
def test_gemm_nn_joined_kernel_matches_plain(dev, dtype, pairs, offset):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(12)
    M, N, K = 200, 96, 64
    a = _offset_views(g, dev, dtype, pairs, (M, K), offset)
    b = _offset_views(g, dev, dtype, pairs, (K, N), offset, std=K**-0.5)
    before = m.gemm_nn.launches
    out = m.gemm_nn(a, b, "store_f32")
    ref = m.gemm_nn_plain(a, b, "store_f32")
    assert m.gemm_nn.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert (out - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 200, 1000, 28800])
@pytest.mark.parametrize("N, K", [(48, 64), (49, 64), (64, 100), (512, 512), (1024, 512)])
def test_wgrad_kernel_matches_plain(dev, dtype, R, N, K):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(13)
    gr, x = _rnd(g, dev, R, N).to(dtype), _rnd(g, dev, R, K).to(dtype)
    before = m.wgrad.launches
    out, again = m.wgrad(gr, x), m.wgrad(gr, x)
    ref = m.wgrad_plain(gr, x)
    assert m.wgrad.launches == before + 2
    assert out.dtype == dtype and out.shape == (N, K)
    assert torch.equal(out, again), "two runs of a weight gradient differ"
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3, 8, 64])
@pytest.mark.parametrize("offset", [0, 1])
def test_wgrad_kernel_splits_match_plain(dev, dtype, splits, offset):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(14)
    R, N, K = 1000, 96, 72
    (gr,), (x,) = _offset_views(g, dev, dtype, 1, (R, N), offset), _offset_views(g, dev, dtype, 1, (R, K), offset)
    out, again = m.wgrad(gr, x, splits), m.wgrad(gr, x, splits)
    ref = m.wgrad_plain(gr, x)
    assert torch.equal(out, again), "two runs of a weight gradient differ"
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


def test_fma_body_refuses_bf16(dev, tmp_path):
    """No bf16 product can fall back to the FMA body: an instance of
    gemm_t (and so gemm_kernel) in bf16 does not compile; in f32 it does."""
    import subprocess

    from tcdiff_torch.ops import _build

    for dtype, compiles in (("float", True), ("__nv_bfloat16", False)):
        src = tmp_path / f"fma_{dtype}.cu"
        src.write_text(f'#include "{_build.CSRC / "common.cuh"}"\n'
                       f"template void tcd::gemm_t<{dtype}, false, false, tcd::EPI_STORE>(const {dtype}*, "
                       f"const {dtype}*, int, int, int, tcd::EpiArgs, cudaStream_t, int);\n")
        res = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-c",
                              "-o", str(tmp_path / "fma.o"), str(src)], capture_output=True, text=True)
        assert (res.returncode == 0) == compiles, res.stderr
        assert compiles or "run on the tensor cores" in res.stderr, res.stderr


def test_backward_gemms_refuse_what_they_do_not_take(dev):
    from tcdiff_torch.ops import gemm as m

    a, b = torch.zeros(8, 16, device=dev), torch.zeros(16, 4, device=dev)
    with pytest.raises(ValueError):  # the forward's epilogue
        m.gemm_nn(a, b, "bias")
    with pytest.raises(ValueError):  # b is not (K, N)
        m.gemm_nn(a, b[:8].contiguous())
    with pytest.raises(ValueError):  # more than two joined pairs
        m.gemm_nn([a] * 3, [b] * 3, "store_f32")
    with pytest.raises(ValueError):  # acc_f32 without an f32 out
        m.gemm_nn(a, b, "acc_f32")
    with pytest.raises(ValueError):  # g and x of other row counts
        m.wgrad(a, a[:4].contiguous())
    with pytest.raises(ValueError):
        m.wgrad(a, a, splits=0)
    with pytest.raises(TypeError):
        m.wgrad(a.half(), a.half())


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 8, 256, device=dev)
    w = torch.zeros(256, 256, device=dev)
    v = torch.ones(256, device=dev)
    with pytest.raises(ValueError):  # dk = 128 > 64
        sa_block.sa_block(x, v, v, angle_table(8, 256, dev), w, w, w, w, v, v, nhead=2)
    with pytest.raises(TypeError):
        sa_block.sa_block(x.half(), v, v, angle_table(8, 256, dev), w, w, w, w, v, v, nhead=4)
    with pytest.raises(ValueError):
        ff_block.ff_tail(x, v, v, w, v, w, v, v[None], v[None], v, v, w[:, :128], v)


# ------------------------------------------------------------ per-op kernels
# K8-K11 against their plain versions: row counts and lengths that are not
# multiples of a tile (GEMM 64; attention 64 queries x 64 keys in bf16,
# 64 x 32 in f32), Lq != Lk, a narrow d = 64, head dims 16, 20, 32 and 64
# (20 is padded to the mma's 32 and copied in 2-byte pieces), and K8's
# rot-only form.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, d", [(2 * 37, 64), (3 * 100, 512)])
def test_layernorm_kernel_matches_plain(dev, dtype, rows, d):
    from tcdiff_torch.ops import layernorm as m

    g = torch.Generator(device=dev).manual_seed(5)
    x = (3.0 * _rnd(g, dev, rows // 2, 2, d) + 1.0).to(dtype)
    s, b = 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1)
    before = m.layernorm.launches
    out = m.layernorm(x, s, b, 1e-6)
    ref = m.layernorm_plain(x, s, b, 1e-6)
    assert m.layernorm.launches == before + 1 and out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


# Every variant of the LayerNorm row body (csrc/common.cuh ln_rows, the
# LayerNorm stage of every kernel) through its test entry: the templated
# widths 64, 256, 512 and 1024 and the general body (96), 3 x 37 rows (odd,
# and not a multiple of the 8 warps of a block).
LN_VARIANTS = {
    "plain": dict(),
    "rotary": dict(angles=True),
    "rotary_only": dict(angles=True, normed=False),
    "film": dict(film=True),
    "f32_input": dict(f32_in=True),
}


def _ln_rows_case(g, dev, dtype, variant, b, l, d, x=None):
    opt = LN_VARIANTS[variant]
    if x is None:
        x = 3.0 * _rnd(g, dev, b, l, d) + 1.0
        x = x if opt.get("f32_in") else x.to(dtype)
    kw = dict(dtype=dtype, angles=angle_table(l, d, dev) if opt.get("angles") else None,
              normed=opt.get("normed", True))
    if opt.get("film"):
        kw.update(film_scale=_rnd(g, dev, b, d, std=0.1), film_shift=_rnd(g, dev, b, d, std=0.1),
                  resid=_rnd(g, dev, b, l, d).to(dtype))
    return x, 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1), kw


def _check_ln_rows(x, s, b, kw, dtype):
    from tcdiff_torch.ops import layernorm as m

    before = m.ln_rows.launches
    outs = m.ln_rows(x, s, b, 1e-5, **kw)
    refs = m.ln_rows_plain(x, s, b, 1e-5, **kw)
    torch.cuda.synchronize()
    assert m.ln_rows.launches == before + 1
    for out, ref in zip(outs, refs):
        assert (out is None) == (ref is None)
        if ref is not None:
            assert out.dtype == dtype and out.shape == x.shape
            assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(LN_VARIANTS))
@pytest.mark.parametrize("d", [64, 96, 256, 512, 1024])
def test_ln_rows_kernel_matches_plain(dev, dtype, variant, d):
    g = torch.Generator(device=dev).manual_seed(12)
    _check_ln_rows(*_ln_rows_case(g, dev, dtype, variant, 3, 37, d), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(LN_VARIANTS))
def test_ln_rows_kernel_takes_unaligned_rows(dev, dtype, variant):
    # rows that start 4 bytes past a 16-byte boundary: the general body at d = 512
    g = torch.Generator(device=dev).manual_seed(13)
    xt = torch.float32 if variant == "f32_input" else dtype
    buf = (3.0 * _rnd(g, dev, 3 * 37 * 512 + 2) + 1.0).to(xt)
    x = buf[4 // buf.element_size():][: 3 * 37 * 512].view(3, 37, 512)
    _check_ln_rows(*_ln_rows_case(g, dev, dtype, variant, 3, 37, 512, x=x), dtype)


def _k9_args(g, dev, dtype, d, n, b=B, l=77, bias_std=8.0):
    """K9's operands; a bias of ~8 shows the rounding order: T(T(acc) + T(b))
    against T(acc + b) differs in about 30% of the bf16 outputs."""
    return (_rnd(g, dev, b, l, d).to(dtype), 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1),
            _rnd(g, dev, n, d, std=d**-0.5).to(dtype), _rnd(g, dev, n, std=bias_std))


# (d, n, b, l, the bias's std in bf16): the first three at a bias of ~1,
# whose tolerance (2^-5 of the largest output) is set by the product
# itself, the others at ~8, whose tolerance the bias sets; in bf16 every
# case also counts the outputs off the plain version's bits. f32 takes a
# bias of ~1 throughout: its tolerance is its only check of the product.
K9_CASES = [(64, 48, B, 77, 1.0), (D, FF, B, 77, 1.0), (D, D, B, 77, 1.0), (64, 40, B, 37, 8.0),
            (512, 1024, 8, 450, 8.0), (512, 512, 8, 450, 8.0), (1024, 512, B, 37, 8.0), (96, 200, B, 37, 8.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d, n, b, l, bias_std", K9_CASES)
def test_ln_matmul_kernel_matches_plain(dev, dtype, d, n, b, l, bias_std):
    """K9: bf16 the row body and one launch of the wgmma body (no mma.sync
    launch), the product rounded before the bias: the plain version's bits
    but for a rare product rounded the other way by the order of the f32
    sums; f32 the FMA sequence (neither tensor-core body)."""
    from tcdiff_torch.ops import ln_matmul as m
    from tcdiff_torch.ops._common import ln_f32, mm_f32

    g = torch.Generator(device=dev).manual_seed(6)
    bias_std = bias_std if dtype == torch.bfloat16 else 1.0
    x, s, bb, w, bias = _k9_args(g, dev, dtype, d, n, b, l, bias_std)
    before, bodies = m.ln_matmul.launches, _bodies("ln_matmul")
    out = m.ln_matmul(x, s, bb, w, bias)
    ref = m.ln_matmul_plain(x, s, bb, w, bias)
    torch.cuda.synchronize()
    after = _bodies("ln_matmul")
    assert m.ln_matmul.launches == before + 1 and out.shape == (b, l, n) and out.dtype == dtype
    want = (1, 0) if dtype == torch.bfloat16 else (0, 0)
    assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == want
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)
    if dtype == torch.bfloat16:
        other = (mm_f32(ln_f32(x, s, bb, 1e-5).to(dtype), w) + bias).to(dtype)
        assert (out != ref).float().mean().item() <= 0.01
        assert (other != ref).float().mean().item() > 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, D])
@pytest.mark.parametrize("rot_only", [False, True])
def test_ln_rotary_matmul_kernel_matches_plain(dev, dtype, d, rot_only):
    from tcdiff_torch.ops import ln_rotary_matmul as m

    g = torch.Generator(device=dev).manual_seed(7)
    lx = 45
    x = _rnd(g, dev, B, lx, d).to(dtype)
    s, b = 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1)
    wr = _rnd(g, dev, 96 if rot_only else 192, d, std=d**-0.5).to(dtype)
    wp = None if rot_only else _rnd(g, dev, 96, d, std=d**-0.5).to(dtype)
    before = m.ln_rotary_matmul.launches
    out = m.ln_rotary_matmul(x, s, b, angle_table(lx, d, dev), wr, wp)
    ref = m.ln_rotary_matmul_plain(x, s, b, angle_table(lx, d, dev), wr, wp)
    assert m.ln_rotary_matmul.launches == before + 1
    outs, refs = (out, ref) if wp is not None else ((out,), (ref,))
    for o, r in zip(outs, refs):
        assert o.dtype == dtype and o.shape == r.shape
        assert (o.float() - r.float()).abs().max().item() <= _tol(dtype, r)


def _attn_bodies(lib: str) -> dict:
    from tcdiff_torch.ops.attention import attn_body_launches

    return attn_body_launches(lib)


def _bodies_since(before: dict, lib: str) -> dict:
    from tcdiff_torch.ops.attention import attn_body_launches

    now = attn_body_launches(lib)
    return {k: now[k] - before[k] for k in now}


def _ran(dtype, dk: int, trpe: bool, calls: int) -> dict:
    """The per-body launch counts `calls` calls of attention_plan's body make
    (f32 counts under neither bf16 body)."""
    from tcdiff_torch.ops.attention import attention_plan

    body = attention_plan(dtype, dk, trpe, True, 1, 1, 1)["body"]
    return {b: calls if b == body else 0 for b in ("mma.sync", "wgmma")}


# Lq and Lk of 1, 65, 66, 129, 152, 450 and 600: the wgmma body's 128-query
# tiles, 64-key halves and 128-key stages, each one past or short of an edge.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq, lk, dk", [(100, 100, 64), (100, 38, 64), (37, 70, 16), (150, 150, 64),
                                       (450, 450, 64), (450, 152, 64), (37, 53, 32), (1, 70, 64), (53, 37, 20),
                                       (1, 1, 64), (65, 66, 64), (66, 65, 64), (129, 152, 64), (152, 129, 64),
                                       (600, 600, 64), (600, 152, 64), (1, 600, 64), (450, 1, 64)])
@pytest.mark.parametrize("trpe", [False, True])
def test_attention_kernel_matches_plain(dev, dtype, lq, lk, dk, trpe):
    from tcdiff_torch.ops import attention as m

    g = torch.Generator(device=dev).manual_seed(8)
    h = 3
    # (b, h, L, dk) views of (b, L, h*dk) projections, as the decoder passes them
    heads = lambda n: _rnd(g, dev, B, n, h * dk).to(dtype).view(B, n, h, dk).transpose(1, 2)
    q, k, v = heads(lq), heads(lk), heads(lk)
    table = _rnd(g, dev, h, 10, dk) if trpe else None
    dist = torch.randint(-1, 12, (B, lq, lk), generator=g, device=dev) if trpe else None
    scale = dk**-0.5
    before, bodies = m.attention.launches, m.attn_body_launches()
    out = m.attention(q, k, v, scale, table, dist)
    ref = m.attention_plain(q, k, v, scale, table, dist)
    assert m.attention.launches == before + 1 and out.dtype == dtype and out.shape == (B, h, lq, dk)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)
    # contiguous (b, h, L, dk) inputs give the same result
    again = m.attention(q.contiguous(), k.contiguous(), v.contiguous(), scale, table, dist)
    assert torch.equal(again, out)
    assert _bodies_since(bodies, "attention") == _ran(dtype, dk, trpe, 2)


def _off16(t: torch.Tensor) -> torch.Tensor:
    """t's values in a view one element past a 16-byte boundary (the same
    strides), which TMA cannot address: the mma.sync body's call."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_attention_bodies_at_the_cells_call(dev):
    """The serving cell's call, 256 rows x 8 heads at 450 x 450 (dk 64,
    bf16, (b, L, h*dk) views): the wgmma body against the plain version,
    and against the mma.sync body (q one element off a 16-byte boundary)
    within bf16 rounding."""
    from tcdiff_torch.ops import attention as m

    g = torch.Generator(device=dev).manual_seed(23)
    rows, h, n, dk = 256, 8, 450, 64
    heads = lambda x: x.view(rows, n, h, dk).transpose(1, 2)
    q, k, v = (heads(_rnd(g, dev, rows, n, h * dk).to(torch.bfloat16)) for _ in range(3))
    bodies = m.attn_body_launches()
    out = m.attention(q, k, v, dk**-0.5)
    assert _bodies_since(bodies, "attention") == {"mma.sync": 0, "wgmma": 1}
    ref = m.attention_plain(q, k, v, dk**-0.5)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)
    bodies = m.attn_body_launches()
    sync = m.attention(heads(_off16(q.transpose(1, 2).reshape(rows, n, h * dk))), k, v, dk**-0.5)
    assert _bodies_since(bodies, "attention") == {"mma.sync": 1, "wgmma": 0}
    assert (out.float() - sync.float()).abs().max().item() <= _tol(torch.bfloat16, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk, trpe, offset", [(64, False, False), (64, True, False), (64, False, True),
                                              (32, False, False), (20, False, False)])
@pytest.mark.parametrize("lq, rows, heads", [(450, 256, 8), (450, 128, 8), (600, 256, 8), (1, 1, 1)])
def test_attention_plan_is_the_c_rule(dev, dtype, dk, trpe, offset, lq, rows, heads):
    """ops/attention.attention_plan gives what the C code's tcd_attn_plan
    gives, and `tma_aligned` reads a view one element off a 16-byte
    boundary as not aligned."""
    from tcdiff_torch.ops import attention as m

    view = torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16, device=dev)
    aligned = m.tma_aligned(_off16(view) if offset else view)
    assert aligned == (not offset)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args = (dtype, dk, trpe, aligned, lq, rows, heads, sms)
    assert m.c_plan(*args) == m.attention_plan(*args)


def test_per_op_kernels_refuse_what_they_do_not_take(dev):
    from tcdiff_torch.ops.attention import attention
    from tcdiff_torch.ops.layernorm import layernorm
    from tcdiff_torch.ops.ln_matmul import ln_matmul
    from tcdiff_torch.ops.ln_rotary_matmul import ln_rotary_matmul

    x = torch.zeros(1, 8, 64, device=dev)
    v = torch.ones(64, device=dev)
    with pytest.raises(ValueError):  # odd d
        layernorm(torch.zeros(1, 8, 63, device=dev), v[:63], v[:63])
    with pytest.raises(ValueError):  # a weight of another width
        ln_matmul(x, v, v, torch.zeros(32, 48, device=dev), v[:32])
    with pytest.raises(ValueError):  # an angle table of another length
        ln_rotary_matmul(x, v, v, angle_table(9, 64, dev), torch.zeros(32, 64, device=dev))
    q = torch.zeros(1, 2, 8, 128, device=dev)
    with pytest.raises(ValueError):  # dk = 128 > 64
        attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        attention(q[..., :64].half(), q[..., :64].half(), q[..., :64].half(), 0.1)


# ------------------------------------------------------------- train blocks
# K3, K4, K5 against their plain versions on the same CUDA tensors: the
# output and every gradient under one cotangent, at rate 0 and 0.1 with the
# same seeds (the hash masks are the same bits). dk = 64 as on the main
# path. Tolerances, of the largest reference value of each tensor: f32
# 1e-4 for the output and the gradients (sums in another order); bf16 2^-5
# for the output, as above, and 2^-4 for the gradients, since the plain
# version's autograd rounds dP, dO and the operands of the weight
# gradients to bf16 at other points than the kernels do.
TB, TL, TLM, TD, TH, TFF = 2, 100, 40, 128, 2, 256
THD = TH * 64


def _train_tol(dtype, ref, grad):
    scale = max(ref.abs().max().item(), 1e-6)
    if dtype == torch.float32:
        return 1e-4 * scale
    return (2.0**-4 if grad else 2.0**-5) * scale


def _check_train_op(fn, plain, counter, args, diff_idx, kw, dtype, gen):
    """Run the kernel and the plain version on the same leaves; compare the
    output and the gradients of the inputs at diff_idx; run the kernel's
    backward twice: the same bits (every sum in a fixed order)."""
    leaves = [a.detach().clone().requires_grad_(i in diff_idx) if torch.is_tensor(a) and a.is_floating_point()
              else a for i, a in enumerate(args)]
    leaves_p = [a.detach().clone().requires_grad_(i in diff_idx) if torch.is_tensor(a) and a.is_floating_point()
                else a for i, a in enumerate(args)]
    before, before_b = counter.launches, counter.bwd_launches
    out = fn(*leaves, **kw)
    ref = plain(*leaves_p, **kw)
    cot = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    grads = torch.autograd.grad(out, [leaves[i] for i in diff_idx], cot, retain_graph=True)
    again = torch.autograd.grad(out, [leaves[i] for i in diff_idx], cot)
    grads_p = torch.autograd.grad(ref, [leaves_p[i] for i in diff_idx], cot)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and counter.bwd_launches == before_b + 2
    for i, g, g2 in zip(diff_idx, grads, again):
        assert torch.equal(g, g2), f"the gradient of input {i} differs between two backward runs"
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _train_tol(dtype, ref.float(), False)
    for i, g, gp in zip(diff_idx, grads, grads_p):
        assert g.dtype == gp.dtype and g.shape == gp.shape, i
        err = (g.float() - gp.float()).abs().max().item()
        assert err <= _train_tol(dtype, gp.float(), True), (i, err)


def _train_inputs(gen, dev, dtype, b=TB):
    r = lambda *s, std=1.0: _rnd(gen, dev, *s, std=std)
    w = lambda o, i: r(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1 + r(TD, std=0.1), r(TD, std=0.1))
    seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
    return r, w, ln, seeds


# (b, L): the small shape, and one whose b L = 1200 rows the weight
# gradients cut into 19 chunks (ops/train_common.py::weight_splits)
TRAIN_SIZES = [(TB, TL), (8, 150)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b, l", TRAIN_SIZES)
def test_sa_block_train_kernels_match_plain(dev, dtype, rate, b, l):
    from tcdiff_torch.ops import sa_block_train as m

    g = torch.Generator(device=dev).manual_seed(2)
    r, w, ln, seeds = _train_inputs(g, dev, dtype, b)
    (s1, b1), (s2, b2) = ln(), ln()
    args = (r(b, l, TD).to(dtype), s1, b1, angle_table(l, TD, dev), w(THD, TD), w(THD, TD),
            w(THD, TD), w(TD, THD), s2, b2, r(b, TD, std=0.1).to(dtype), r(b, TD, std=0.1).to(dtype), seeds)
    _check_train_op(m.sa_block_train, m.sa_block_train_plain, m.sa_block_train, args,
                    (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11), dict(nhead=TH, rate=rate), dtype, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ca_block_train_kernels_match_plain(dev, dtype, rate):
    from tcdiff_torch.ops import ca_block_train as m

    g = torch.Generator(device=dev).manual_seed(3)
    r, w, ln, seeds = _train_inputs(g, dev, dtype)
    (s2, b2), (ss, sb) = ln(), ln()
    args = (r(TB, TL, TD).to(dtype), r(TB, TLM, TD).to(dtype), s2, b2, angle_table(TL, TD, dev),
            angle_table(TLM, TD, dev), w(THD, TD), w(THD, TD), w(THD, TD), w(TD, THD), ss, sb,
            r(TB, TD, std=0.1).to(dtype), r(TB, TD, std=0.1).to(dtype), seeds)
    _check_train_op(m.ca_block_train, m.ca_block_train_plain, m.ca_block_train, args,
                    (0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13), dict(nhead=TH, rate=rate), dtype, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("ff", [TFF, TD // 2])  # ff < d too: dW3 is then the largest partial
@pytest.mark.parametrize("b, l", TRAIN_SIZES)
def test_ff_tail_train_kernels_match_plain(dev, dtype, rate, ff, b, l):
    from tcdiff_torch.ops import ff_block_train as m

    g = torch.Generator(device=dev).manual_seed(4)
    r, w, ln, seeds = _train_inputs(g, dev, dtype, b)
    (s3, b3), (s4, b4) = ln(), ln()
    args = (r(b, l, TD).to(dtype), s3, b3, w(ff, TD), r(ff, std=0.1), w(TD, ff), r(TD, std=0.1),
            r(b, TD, std=0.1).to(dtype), r(b, TD, std=0.1).to(dtype), s4, b4, w(TD, TD), r(TD, std=0.1), seeds)
    _check_train_op(m.ff_tail_train, m.ff_tail_train_plain, m.ff_tail_train, args,
                    tuple(range(13)), dict(rate=rate), dtype, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq, lk, dk", [(450, 450, 64), (450, 152, 64), (150, 150, 64), (37, 53, 32), (1, 70, 16),
                                       (1, 66, 64), (65, 66, 64), (129, 152, 64), (600, 600, 64), (600, 152, 64),
                                       (66, 450, 64)])
def test_attention_train_kernels_match_plain(dev, dtype, rate, lq, lk, dk):
    """The train attention alone (K3's and K4's) against the plain chain:
    the output and the gradients of q, k and v, each within 2^-5 (bf16) or
    1e-4 (f32) of its largest value; a second backward on the same inputs
    gives the same bits (no atomics: each gradient row is one block's)."""
    from tcdiff_torch.ops import sa_block_train as m

    g = torch.Generator(device=dev).manual_seed(6)
    h = 3
    q, k, v = (_rnd(g, dev, TB, n, h * dk).to(dtype) for n in (lq, lk, lk))
    seeds = torch.randint(0, 2**32, (TB,), generator=g, device=dev, dtype=torch.int64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    leaves_p = [t.clone().requires_grad_() for t in (q, k, v)]
    before, before_b = m.attention_train.launches, m.attention_train.bwd_launches
    bodies = _attn_bodies("sa_block_train")
    out = m.attention_train(*leaves, seeds, nhead=h, rate=rate)
    assert _bodies_since(bodies, "sa_block_train") == _ran(dtype, dk, False, 1)
    ref = m.attention_plain(*leaves_p, seeds, h, rate)
    cot = _rnd(g, dev, *out.shape).to(dtype)
    grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    again = torch.autograd.grad(out, leaves, cot)
    grads_p = torch.autograd.grad(ref, leaves_p, cot)
    torch.cuda.synchronize()
    assert m.attention_train.launches == before + 1 and m.attention_train.bwd_launches == before_b + 2
    tol = lambda r: (2.0**-5 if dtype == torch.bfloat16 else 1e-4) * max(r.float().abs().max().item(), 1e-6)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol(ref)
    for name, gk, ga, gp in zip("qkv", grads, again, grads_p):
        assert gk.dtype == dtype and gk.shape == gp.shape, name
        err = (gk.float() - gp.float()).abs().max().item()
        assert err <= tol(gp), (name, err, tol(gp))
        assert torch.equal(gk, ga), f"d{name} differs between two backward runs"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq, lk", [(450, 450), (600, 152), (65, 129)])
def test_attention_train_bodies_agree_bit_for_bit(dev, rate, lq, lk):
    """The train forward on its two bf16 bodies (wgmma; mma.sync for q one
    element off a 16-byte boundary) on the same seeds: the lse bit for bit,
    the output within bf16 rounding, and the dropout mask bit for bit,
    read from q = 0 (every probability 1 before dropout) against v one-hot
    over a 64-key block of the keys: o[i, c] != 0 iff key 64 blk + c of
    row i is kept."""
    from tcdiff_torch.ops import sa_block_train as m

    g = torch.Generator(device=dev).manual_seed(11)
    h, dk, bf = 3, 64, torch.bfloat16
    q, k, v = (_rnd(g, dev, TB, n, h * dk).to(bf) for n in (lq, lk, lk))
    seeds = torch.randint(0, 2**32, (TB,), generator=g, device=dev, dtype=torch.int64)
    bodies = _attn_bodies("sa_block_train")
    o_wg, lse_wg = m.attention_train_fwd(q, k, v, seeds, nhead=h, rate=rate)
    o_mma, lse_mma = m.attention_train_fwd(_off16(q), k, v, seeds, nhead=h, rate=rate)
    assert _bodies_since(bodies, "sa_block_train") == {"mma.sync": 1, "wgmma": 1}
    assert torch.equal(lse_wg, lse_mma)
    assert (o_wg.float() - o_mma.float()).abs().max().item() <= _tol(bf, o_mma)
    zero = torch.zeros_like(q)
    for blk in range(-(-lk // 64)):
        onehot = torch.zeros(lk, dk, device=dev)
        keys = torch.arange(64 * blk, min(64 * blk + 64, lk), device=dev)
        onehot[keys, keys - 64 * blk] = 1.0
        vb = onehot.repeat(1, h)[None].expand(TB, lk, h * dk).to(bf).contiguous()
        masks = [m.attention_train_fwd(qq, k, vb, seeds, nhead=h, rate=rate)[0] != 0 for qq in (zero, _off16(zero))]
        assert torch.equal(masks[0], masks[1]), f"keys {64 * blk}..: the dropout masks differ"
        kept = masks[0].view(TB, lq, h, dk)[..., : keys.numel()].float().mean().item()
        assert (kept == 1.0) if rate == 0 else (0.8 < kept < 0.98)


def test_train_kernels_refuse_what_they_do_not_take(dev):
    from tcdiff_torch.ops.ca_block_train import ca_block_train
    from tcdiff_torch.ops.ff_block_train import ff_tail_train
    from tcdiff_torch.ops.sa_block_train import sa_block_train

    x = torch.zeros(2, 8, 256, device=dev)
    w = torch.zeros(256, 256, device=dev)
    v = torch.ones(256, device=dev)
    f = torch.zeros(2, 256, device=dev)
    s = torch.zeros(2, dtype=torch.int64, device=dev)
    a = angle_table(8, 256, dev)
    with pytest.raises(ValueError):  # dk = 128 > 64
        sa_block_train(x, v, v, a, w, w, w, w, v, v, f, f, s, nhead=2, rate=0.1)
    with pytest.raises(TypeError):
        sa_block_train(x.half(), v, v, a, w, w, w, w, v, v, f, f, s, nhead=4, rate=0.1)
    with pytest.raises(ValueError):  # memory of another batch
        ca_block_train(x, x[:1], v, v, a, a, w, w, w, w, v, v, f, f, s, nhead=4, rate=0.1)
    with pytest.raises(ValueError):  # film rows of another batch
        ff_tail_train(x, v, v, w, v, w, v, f[:1], f[:1], v, v, w, v, s, rate=0.1)


# ------------------------------------------------------- K2b, K7, K6 (serving)
# The FF block without its tail, the serving cross-attention block and the
# whole layer against their plain versions on the same CUDA tensors, with
# and without the FiLM rows / the FF section: L and Lm off the tiles
# (GEMM 64 rows, attention 64 queries x 32 keys), dk = 64 as on the main
# path. Tolerances as above.
SL, SLM = 100, 38


def _serving_inputs(gen, dev, dtype):
    r = lambda *s, std=1.0: _rnd(gen, dev, *s, std=std)
    w = lambda o, i: r(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1 + r(D, std=0.1), r(D, std=0.1))
    film = lambda: (r(B, D, std=0.1).to(dtype), r(B, D, std=0.1).to(dtype))
    return r, w, ln, film


def _check_serving(fn, plain, args, kw, dtype, counter=None):
    counter = counter or fn  # the wrapper whose `launches` counts fn's launches
    before = counter.launches
    out = fn(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.isfinite(out).all().item()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [False, True])
def test_ff_block_kernel_matches_plain(dev, dtype, film):
    g = torch.Generator(device=dev).manual_seed(9)
    r, w, ln, fl = _serving_inputs(g, dev, dtype)
    args = (r(B, SL, D).to(dtype), *ln(), w(FF, D), r(FF, std=0.1), w(D, FF), r(D, std=0.1),
            *(fl() if film else (None, None)))
    _check_serving(ff_block.ff_block, ff_block.ff_block_plain, args, {}, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [False, True])
def test_ca_block_kernel_matches_plain(dev, dtype, film):
    from tcdiff_torch.models.rotary import apply_rotary
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(10)
    r, w, ln, fl = _serving_inputs(g, dev, dtype)
    mem = r(B, SLM, D).to(dtype)
    args = (r(B, SL, D).to(dtype), *ln(), angle_table(SL, D, dev), mem, apply_rotary(mem, angle_table(SLM, D, dev)),
            w(128, D), w(128, D), w(128, D), w(D, 128), *ln(), *(fl() if film else (None, None)))
    _check_serving(m.ca_block, m.ca_block_plain, args, dict(nhead=H), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("include_ff", [False, True])
def test_layer_kernel_matches_plain(dev, dtype, include_ff):
    from tcdiff_torch.ops import layer as m

    g = torch.Generator(device=dev).manual_seed(11)
    r, w, ln, fl = _serving_inputs(g, dev, dtype)
    head = (r(B, SL, D).to(dtype), angle_table(SL, D, dev), *ln(), w(128, D), w(128, D), w(128, D), w(D, 128),
            *ln(), *fl(), *ln(), w(128, D), w(D, 128), *ln(), r(B, SLM, 128).to(dtype), r(B, SLM, 128).to(dtype),
            *fl())
    ff = (*ln(), w(FF, D), r(FF, std=0.1), w(D, FF), r(D, std=0.1), *fl(), *ln(), w(D, D), r(D, std=0.1))
    bodies = _attn_bodies("layer")
    _check_serving(m.layer, m.layer_plain, head + (ff if include_ff else ()), dict(nhead=H, include_ff=include_ff),
                   dtype)
    # the self-attention and the cross-attention over the given k/v
    assert _bodies_since(bodies, "layer") == _ran(dtype, 128 // H, False, 2)


def test_serving_block_kernels_refuse_what_they_do_not_take(dev):
    from tcdiff_torch.ops.ca_block import ca_block
    from tcdiff_torch.ops.layer import layer

    x = torch.zeros(2, 8, 256, device=dev)
    w = torch.zeros(256, 256, device=dev)
    v = torch.ones(256, device=dev)
    f = torch.zeros(2, 256, device=dev)
    a = angle_table(8, 256, dev)
    mem = torch.zeros(2, 5, 256, device=dev)
    kv = torch.zeros(2, 5, 256, device=dev)
    with pytest.raises(ValueError):  # film rows of another batch
        ff_block.ff_block(x, v, v, w, v, w, v, f[:1], f[:1])
    with pytest.raises(ValueError):  # one film row without the other
        ff_block.ff_block(x, v, v, w, v, w, v, f, None)
    with pytest.raises(TypeError):
        ff_block.ff_block(x.half(), v, v, w, v, w, v)
    with pytest.raises(ValueError):  # dk = 128 > 64
        ca_block(x, v, v, a, mem, mem, w, w, w, w, v, v, nhead=2)
    with pytest.raises(ValueError):  # memory of another batch
        ca_block(x, v, v, a, mem[:1], mem[:1], w, w, w, w, v, v, nhead=4)
    with pytest.raises(TypeError):
        ca_block(x.half(), v, v, a, mem, mem, w, w, w, w, v, v, nhead=4)
    head = lambda x, kv: (x, a, v, v, w, w, w, w, v, v, f, f, v, v, w, w, v, v, kv, kv, f, f)
    with pytest.raises(ValueError):  # k/v of another width
        layer(*head(x, kv[..., :128]), nhead=4, include_ff=False)
    with pytest.raises(ValueError):  # include_ff without the FF section
        layer(*head(x, kv), nhead=4)
    with pytest.raises(TypeError):
        layer(*head(x.half(), kv), nhead=4, include_ff=False)


# K7 over the hoisted k/v (ca_kv): the music rows' and the time rows' k/v
# read apart, the FiLM residual inside. At the benchmark's shape (256 rows,
# 128 clips under CFG: L = 450, 150 + 2 keys, d = 512, 8 x 64 heads), at
# b = 8 (the serving shape of chip_smoke.py) and at lengths off the tiles
# (37 queries, 38 + 2 and 250 + 6 keys, dk = 16); the time rows a strided
# view of all layers' projections, as the decoder's hoist makes them.
def _ca_kv_args(g, dev, dtype, b, l, lm, d=D, hd=128, nl=8, layer=3):
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    w = lambda o, i: r(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1 + r(d, std=0.1), r(d, std=0.1))
    time_rows = lambda: torch.einsum("btd,lhd->lbth", r(b, 2, d).to(dtype), r(nl, hd, d, std=d**-0.5).to(dtype))[layer]
    return (r(b, l, d).to(dtype), *ln(), angle_table(l, d, dev), r(b, lm, hd).to(dtype), r(b, lm, hd).to(dtype),
            time_rows(), time_rows(), w(hd, d), w(d, hd), *ln(), r(b, d, std=0.1), r(b, d, std=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, l, lm, d, hd, nhead", [(256, 450, 150, 512, 512, 8), (8, 450, 150, 512, 512, 8),
                                                    (2, 37, 38, D, 128, H), (3, 100, 250, D, 64, 4)])
def test_ca_kv_kernel_matches_plain(dev, dtype, b, l, lm, d, hd, nhead):
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(17)
    args = _ca_kv_args(g, dev, dtype, b, l, lm, d, hd)
    if lm == 250:  # 256 keys, all a block holds: six time rows
        args = args[:6] + tuple(torch.cat([t] * 3, dim=1) for t in args[6:8]) + args[8:]
    _check_serving(m.ca_kv, m.ca_kv_plain, args, dict(nhead=nhead), dtype, counter=m.ca_block)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ca_kv_launches_no_attention_kernel(dev, dtype):
    """One call: bf16 3 device kernels (q with its LayerNorm prologue, the
    short-memory attention, fc with its LayerNorm and FiLM fold), f32 5,
    every one hand-written and none named attn_*, the name that counts the
    self-attention's calls; and no copy of the k/v rows."""
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(18)
    args = _ca_kv_args(g, dev, dtype, 16, 450, 150, 512, 512)
    want = 3 if dtype == torch.bfloat16 else 5
    full = _device_names(lambda: m.ca_kv(*args, nhead=8), want)
    names = [n.split("(")[0].split("<")[0].split("::")[-1] for n in full]  # no namespace, template or arguments
    assert len(names) == want and all("tcd::" in n for n in full), full
    assert {"xattn_short_kernel", "xattn_short_fma_kernel"} & set(names), names
    assert not any(n.startswith("attn_") for n in names), names


def test_ca_kv_refuses_what_it_does_not_take(dev):
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(19)
    args = _ca_kv_args(g, dev, torch.bfloat16, 2, 8, 255, 256, 128)
    with pytest.raises(ValueError):  # 255 + 2 keys: more than a block holds
        m.ca_kv(*args, nhead=2)
    args = _ca_kv_args(g, dev, torch.bfloat16, 2, 8, 5, 256, 256)
    with pytest.raises(ValueError):  # dk = 128 > 64
        m.ca_kv(*args, nhead=2)
    with pytest.raises(ValueError):  # time rows of another batch
        m.ca_kv(*args[:6], args[6][:1], args[7][:1], *args[8:], nhead=4)
    with pytest.raises(ValueError):  # film rows of another batch
        m.ca_kv(*args[:12], args[12][:1], args[13][:1], nhead=4)


# K6 at the widths whose bf16 LayerNorm folds run in clusters of 1, 2 and 4
# blocks (d = 128, 256, 512), at a length no tile divides (37) and the
# serving length (450), with and without the FF section; then a bf16 call
# twice, bit for bit (the folds add the cluster's row statistics in rank
# order), and the widths a cluster cannot hold.


def _layer_args(g, dev, dtype, b, l, d, lm=38, hd=128, ff=None):
    ff = ff or 2 * d
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    w = lambda o, i: r(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1 + r(d, std=0.1), r(d, std=0.1))
    fl = lambda: (r(b, d, std=0.1).to(dtype), r(b, d, std=0.1).to(dtype))
    head = (r(b, l, d).to(dtype), angle_table(l, d, dev), *ln(), w(hd, d), w(hd, d), w(hd, d), w(d, hd),
            *ln(), *fl(), *ln(), w(hd, d), w(d, hd), *ln(), r(b, lm, hd).to(dtype), r(b, lm, hd).to(dtype), *fl())
    tail = (*ln(), w(ff, d), r(ff, std=0.1), w(d, ff), r(d, std=0.1), *fl(), *ln(), w(d, d), r(d, std=0.1))
    return head, tail


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("include_ff", [False, True])
@pytest.mark.parametrize("l", [37, 450])
@pytest.mark.parametrize("d", [128, 256, 512])
def test_layer_kernel_widths_match_plain(dev, dtype, include_ff, l, d):
    from tcdiff_torch.ops import layer as m

    g = torch.Generator(device=dev).manual_seed(14)
    head, tail = _layer_args(g, dev, dtype, 2, l, d)
    _check_serving(m.layer, m.layer_plain, head + (tail if include_ff else ()),
                   dict(nhead=2, include_ff=include_ff), dtype)


def test_layer_kernel_repeats_bit_for_bit(dev):
    from tcdiff_torch.ops import layer as m

    g = torch.Generator(device=dev).manual_seed(15)
    head, tail = _layer_args(g, dev, torch.bfloat16, 2, 450, 512)
    first = m.layer(*head, *tail, nhead=2)
    again = m.layer(*head, *tail, nhead=2)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_bf16_blocks_refuse_rows_past_a_cluster(dev):
    from tcdiff_torch.ops import layer as m
    from tcdiff_torch.ops.ca_block import ca_block

    d = 1152  # 9 blocks of 128 columns: more than a cluster of 8 holds
    g = torch.Generator(device=dev).manual_seed(16)
    for dtype in (torch.float32, torch.bfloat16):
        head, tail = _layer_args(g, dev, dtype, 1, 8, d, lm=5, ff=256)
        x, v = head[0], torch.ones(d, device=dev)
        wq, wfc = head[4], head[7]
        sa = (x, v, v, head[1], wq, wq, wq, wfc, v, v)
        ff = (x, v, v, tail[2], tail[3], tail[4], tail[5], tail[6], tail[7], v, v, tail[10], tail[11])
        mem = torch.zeros(1, 5, d, device=dev, dtype=dtype)
        ca = (x, v, v, head[1], mem, mem, wq, wq, wq, wfc, v, v)
        calls = (lambda: m.layer(*head, *tail, nhead=2), lambda: sa_block.sa_block(*sa, nhead=2),
                 lambda: ff_block.ff_tail(*ff), lambda: ca_block(*ca, nhead=2))
        for call in calls:
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError):
                    call()
            else:  # f32 runs the unfused sequence, which takes any even d
                assert torch.isfinite(call()).all().item()


# ------------------------------------------------- K4's and K7's new bodies
# The train row kernels (csrc/train_common.cuh, one warp a row) through
# their test entry (ops/train_common.py) at the widths of their templated
# body (64, 512, 1024) and of the pair-wise one (70 = 2 x 35), at a length
# no chunk divides (L = 37 against chunks of ~32 rows), at rate 0 and 0.1,
# in each form K3, K4 and K5 launch; each backward twice, bit for bit.
# Then K4's memory cotangent (gemm_nn_rot) at Lm = 152 and a ragged Lm,
# K7's q projection with the LayerNorm in its prologue (gemm_lnrot) bit for
# bit equal to ln_rows + gemm, K7 at the prologue's widths, and the widths
# the new bodies refuse. Tolerances as above (_train_tol for the rows).
ROW_WIDTHS = [64, 70, 512, 1024]
ROW_FORMS = {"K3": (True, True, True, "T"), "K4_x": (True, False, True, "T"), "K4_mem": (True, True, False, None),
             "K5": (False, False, True, "f32")}  # (rotary, dadd, LayerNorm, residual)


def _rows_close(out, ref, dtype, grad):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _train_tol(dtype, ref.float(), grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", ROW_WIDTHS)
def test_chain_top_kernels_match_plain(dev, dtype, rate, d):
    from tcdiff_torch.ops import train_common as m

    g = torch.Generator(device=dev).manual_seed(20)
    b, l = 3, 37
    z, x = _rnd(g, dev, b, l, d), _rnd(g, dev, b, l, d).to(dtype)
    s, bias = 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1)
    fs, fb = _rnd(g, dev, b, d, std=0.1), _rnd(g, dev, b, d, std=0.1)
    seeds = torch.randint(0, 2**32, (b,), generator=g, device=dev, dtype=torch.int64)
    before = (m.chain_top_fwd.launches, m.chain_top_bwd.launches)
    out = m.chain_top_fwd(z, x, s, bias, fs, fb, seeds, rate=rate)
    _rows_close(out, m.chain_top_fwd_plain(z, x, s, bias, fs, fb, seeds, rate=rate), dtype, False)
    cot = _rnd(g, dev, b, l, d).to(dtype)
    got = m.chain_top_bwd(cot, z, s, bias, fs, seeds, rate=rate)
    again = m.chain_top_bwd(cot, z, s, bias, fs, seeds, rate=rate)
    ref = m.chain_top_bwd_plain(cot, z, s, bias, fs, seeds, rate=rate)
    torch.cuda.synchronize()
    assert (m.chain_top_fwd.launches, m.chain_top_bwd.launches) == (before[0] + 1, before[1] + 2)
    for i, (a, a2, r) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, a2), f"output {i} differs between two runs"
        _rows_close(a, r, dtype, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(ROW_FORMS))
@pytest.mark.parametrize("d", ROW_WIDTHS)
def test_rows_bwd_kernel_matches_plain(dev, dtype, form, d):
    from tcdiff_torch.ops import train_common as m

    use_rot, use_dadd, use_ln, res = ROW_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(21)
    b, l = 3, 37
    dr = _rnd(g, dev, b, l, d)
    x = (2.0 * _rnd(g, dev, b, l, d) + 0.5).to(dtype) if use_ln else None
    s = 1 + _rnd(g, dev, d, std=0.1) if use_ln else None
    kw = dict(angles=angle_table(l, d, dev) if use_rot else None, dadd=_rnd(g, dev, b, l, d) if use_dadd else None,
              resid=None if res is None else _rnd(g, dev, b, l, d).to(dtype if res == "T" else torch.float32),
              dtype=dtype)
    before = m.rows_bwd.launches
    got = m.rows_bwd(dr, x, s, 1e-5, **kw)
    again = m.rows_bwd(dr, x, s, 1e-5, **kw)
    ref = m.rows_bwd_plain(dr, x, s, 1e-5, **kw)
    torch.cuda.synchronize()
    assert m.rows_bwd.launches == before + 2
    for i, (a, a2, r) in enumerate(zip(got, again, ref)):
        assert (a is None) == (r is None), i
        if r is not None:
            assert torch.equal(a, a2), f"output {i} differs between two runs"
            _rows_close(a, r, dtype, True)


@pytest.mark.parametrize("b, lm", [(64, 152), (3, 37), (1, 1)])
def test_gemm_nn_rot_kernel_matches_plain(dev, b, lm):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(22)
    bf16 = torch.bfloat16
    dk, dv = _rnd(g, dev, b * lm, 512).to(bf16), _rnd(g, dev, b * lm, 512).to(bf16)
    wk, wv = (_rnd(g, dev, 512, 512, std=512**-0.5).to(bf16) for _ in range(2))
    angles = angle_table(lm, 512, dev)
    before = m.gemm_nn_rot.launches
    out = m.gemm_nn_rot(dk, wk, dv, wv, angles)
    ref = m.gemm_nn_rot_plain(dk, wk, dv, wv, angles)
    torch.cuda.synchronize()
    assert m.gemm_nn_rot.launches == before + 1
    assert out.dtype == bf16 and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(bf16, ref.float())


@pytest.mark.parametrize("d", [64, 96, 512, 1024])
@pytest.mark.parametrize("l", [37, 450])
@pytest.mark.parametrize("n", [512, 320])
def test_gemm_lnrot_kernel_is_ln_rows_then_gemm(dev, d, l, n):
    """The prologue runs ln_rows' arithmetic in its order, and the K loop
    the projection's: q is the same bits as ln_rows' rotated output fed to
    gemm, and within tolerance of the plain version, with clusters of 4
    and 3 blocks sharing the rows (N = 512, 320)."""
    from tcdiff_torch.ops import gemm as m
    from tcdiff_torch.ops import layernorm

    g = torch.Generator(device=dev).manual_seed(23)
    bf16 = torch.bfloat16
    b = 8 if l == 450 else 3
    x = (2.0 * _rnd(g, dev, b, l, d) + 0.5).to(bf16)
    s, bias = 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1)
    w = _rnd(g, dev, n, d, std=d**-0.5).to(bf16)
    angles = angle_table(l, d, dev)
    before = m.gemm_lnrot.launches
    q = m.gemm_lnrot(x, s, bias, angles, w, 1e-5)
    r = layernorm.ln_rows(x, s, bias, 1e-5, angles=angles, normed=False)[1]
    q2 = m.gemm(r.view(b * l, d), w).view(b, l, n)
    ref = m.gemm_lnrot_plain(x, s, bias, angles, w, 1e-5)
    torch.cuda.synchronize()
    assert m.gemm_lnrot.launches == before + 1
    assert torch.equal(q, q2)
    assert (q.float() - ref.float()).abs().max().item() <= _tol(bf16, ref.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 1024])
@pytest.mark.parametrize("film", [False, True])
def test_ca_block_kernel_widths_match_plain(dev, dtype, d, film):
    """K7 at the widths of the q prologue's other bodies: its general one
    (96) and 64 rows a block (1024), with and without the FiLM rows."""
    from tcdiff_torch.models.rotary import apply_rotary
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(24)
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    w = lambda o, i: r(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1 + r(d, std=0.1), r(d, std=0.1))
    mem = r(2, SLM, d).to(dtype)
    args = (r(2, SL, d).to(dtype), *ln(), angle_table(SL, d, dev), mem, apply_rotary(mem, angle_table(SLM, d, dev)),
            w(128, d), w(128, d), w(128, d), w(d, 128), *ln(),
            *((r(2, d, std=0.1), r(2, d, std=0.1)) if film else (None, None)))
    _check_serving(m.ca_block, m.ca_block_plain, args, dict(nhead=H), dtype)


def test_ca_block_bf16_makes_four_launches(dev):
    """K7 in bf16: k and v grouped, q with its LayerNorm prologue, the
    attention, fc with its LayerNorm fold, and no other device kernel (the
    wrapper's tables are cached and nothing is cast)."""
    from tcdiff_torch.models.rotary import apply_rotary
    from tcdiff_torch.ops import ca_block as m

    g = torch.Generator(device=dev).manual_seed(25)
    bf16 = torch.bfloat16
    w = lambda o, i: _rnd(g, dev, o, i, std=i**-0.5).to(bf16)
    mem = _rnd(g, dev, 2, SLM, D).to(bf16)
    args = (_rnd(g, dev, 2, SL, D).to(bf16), 1 + _rnd(g, dev, D, std=0.1), _rnd(g, dev, D, std=0.1),
            angle_table(SL, D, dev), mem, apply_rotary(mem, angle_table(SLM, D, dev)), w(128, D), w(128, D),
            w(128, D), w(D, 128), 1 + _rnd(g, dev, D, std=0.1), _rnd(g, dev, D, std=0.1),
            _rnd(g, dev, 2, D, std=0.1), _rnd(g, dev, 2, D, std=0.1))
    names = _device_names(lambda: m.ca_block(*args, nhead=H), 4)  # its first call builds the tables
    assert len(names) == 4 and all("tcd::" in n for n in names), names


def test_new_bodies_refuse_what_they_do_not_take(dev):
    from tcdiff_torch.ops import gemm as m
    from tcdiff_torch.ops import train_common as tc

    bf16 = torch.bfloat16
    x = torch.zeros(1, 8, 1152, device=dev, dtype=bf16)
    v = torch.ones(1152, device=dev)
    with pytest.raises(ValueError):  # d past what the prologue holds
        m.gemm_lnrot(x, v, v, angle_table(8, 1152, dev), torch.zeros(64, 1152, device=dev, dtype=bf16))
    with pytest.raises(TypeError):  # f32 keeps the unfused sequence
        m.gemm_lnrot(x.float(), v, v, angle_table(8, 1152, dev), torch.zeros(64, 1152, device=dev))
    x, v = torch.zeros(1, 8, 64, device=dev, dtype=bf16), torch.ones(64, device=dev)
    with pytest.raises(ValueError):  # N past a cluster of LN_CLUSTER blocks
        m.gemm_lnrot(x, v, v, angle_table(8, 64, dev), torch.zeros(1152, 64, device=dev, dtype=bf16))
    a, w = torch.zeros(16, 64, device=dev, dtype=bf16), torch.zeros(64, 63, device=dev, dtype=bf16)
    with pytest.raises(ValueError):  # an odd N: no rotary pairs
        m.gemm_nn_rot(a, w, a, w, torch.zeros(8, 63, device=dev))
    w = torch.zeros(64, 64, device=dev, dtype=bf16)
    with pytest.raises(TypeError):
        m.gemm_nn_rot(a.float(), w.float(), a.float(), w.float(), angle_table(8, 64, dev))
    for d in (1026, 65):  # past ROW_MAX_D; odd
        dr = torch.zeros(1, 4, d, device=dev)
        with pytest.raises(ValueError):
            tc.rows_bwd(dr, dr.to(bf16), torch.ones(d, device=dev))


# ------------------------------------------------ the wgmma + TMA body
# The bf16 forward projection on wgmma with TMA (csrc/gemm_wgmma.cuh,
# ops/gemm.gemm_wg) against its plain version: each epilogue at M = 1, 154
# and 3600 (ragged against 128-row tiles), N = 96 (ragged against 128
# columns) to 1536, K = 64 to 1024, and N = 50, 49, which the dispatch
# rule sends to mma.sync; the grouped form with an N per product; the
# dispatch to mma.sync of what the body does not take, shown by the
# per-body counts; two runs bit for bit. Then K8 and K2b through the new
# design: the row body, then each product on wgmma (the per-body counts),
# the launches under torch.profiler (K9's too); K9's product on mma.sync
# where an operand is off the body's rule. Tolerances as above.
WG_EPILOGUES = ["store", "store_f32", "bias", "bias_gelu", "bias_film", "bias_film_t", "bias_rounded"]


def _wg_case(g, dev, M, N, K):
    L = GEMM_L[M]
    a, w = _rnd(g, dev, M, K).to(torch.bfloat16), _rnd(g, dev, N, K, std=K**-0.5).to(torch.bfloat16)
    extra = (_rnd(g, dev, N, std=0.1), _rnd(g, dev, M, N).to(torch.bfloat16), _rnd(g, dev, M // L, N, std=0.1),
             _rnd(g, dev, M // L, N, std=0.1), L)
    return a, w, extra


def _bodies(lib):
    from tcdiff_torch.ops import gemm as m

    return m.body_launches(lib)


@pytest.mark.parametrize("epilogue", WG_EPILOGUES)
@pytest.mark.parametrize("M", [1, 154, 3600])
@pytest.mark.parametrize("N, K", [(96, 64), (512, 512), (1024, 512), (1536, 512), (512, 1024), (50, 64), (49, 64)])
def test_gemm_wg_kernel_matches_plain(dev, epilogue, M, N, K):
    """N % 8 == 0 on wgmma; N = 50 and 49 on mma.sync, as gemm_plan says."""
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(40)
    a, w, extra = _wg_case(g, dev, M, N, K)
    before, bodies = m.gemm_wg.launches, _bodies("gemm")
    out = m.gemm_wg(a, w, epilogue, *extra)
    ref = m.gemm_plain(a, w, epilogue, *extra)
    torch.cuda.synchronize()
    after = _bodies("gemm")
    body = m.gemm_plan(M, [N], K)["body"]
    assert body == ("wgmma" if N % 8 == 0 else "mma.sync")
    assert m.gemm_wg.launches == before + 1
    assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == \
        ((1, 0) if body == "wgmma" else (0, 1))
    assert out.dtype == ref.dtype and out.shape == (M, N)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)


@pytest.mark.parametrize("shared_a", [True, False])
@pytest.mark.parametrize("ns", [(96, 200, 8), (512, 1024), (512, 512, 512)])
def test_gemm_wg_groups_of_unequal_n(dev, shared_a, ns):
    """Up to three products with their own N in one launch."""
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(42)
    M, K = 3600, 512
    a = [_rnd(g, dev, M, K).to(torch.bfloat16) for _ in ns]
    w = [_rnd(g, dev, n, K, std=K**-0.5).to(torch.bfloat16) for n in ns]
    ta = a[0] if shared_a else a
    bodies = _bodies("gemm")
    outs = m.gemm_wg(ta, w)
    refs = m.gemm_plain(ta, w)
    torch.cuda.synchronize()
    assert _bodies("gemm")["wgmma"] == bodies["wgmma"] + 1
    for out, ref, n in zip(outs, refs, ns):
        assert out.shape == (M, n)
        assert (out.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)


@pytest.mark.parametrize("case", ["aligned", "a 2 bytes off", "w 2 bytes off", "K % 8 != 0", "bias 4 bytes off",
                                  "resid 2 bytes off", "a group with N % 8 != 0"])
def test_gemm_wg_dispatch_by_alignment(dev, case):
    """Operands the body takes run on wgmma; an A or W 2 bytes off a 16-byte
    boundary, rows of K % 8 != 0, an epilogue operand off 16 bytes or a
    product of N % 8 != 0 in the group send every product to mma.sync (one
    launch each): the per-body counts show which, as gemm_plan says, and
    both agree with the plain version."""
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(43)
    M, N, L = 154, 96, 77
    K = 100 if case == "K % 8 != 0" else 64
    buf = _rnd(g, dev, M * K + N * K + 16).to(torch.bfloat16)
    oa = 1 if case == "a 2 bytes off" else 0
    ow = 1 if case == "w 2 bytes off" else 0
    a = buf[oa:oa + M * K].view(M, K)
    w = buf[M * K + 8 + ow:M * K + 8 + ow + N * K].view(N, K) * K**-0.5
    w = buf[M * K + 8 + ow:M * K + 8 + ow + N * K].view(N, K).copy_(w)
    ws = [w, w[:50].contiguous()] if case == "a group with N % 8 != 0" else [w]
    bias = _rnd(g, dev, N + 1, std=0.1)[(1 if case == "bias 4 bytes off" else 0):][:N]
    resid = _rnd(g, dev, M * N + 1).to(torch.bfloat16)[(1 if case == "resid 2 bytes off" else 0):][:M * N].view(M, N)
    fs, fb = _rnd(g, dev, M // L, N, std=0.1), _rnd(g, dev, M // L, N, std=0.1)
    args = ("bias_film_t", bias, resid, fs, fb, L) if len(ws) == 1 else ("store",)
    plan = m.gemm_plan(M, [wi.shape[0] for wi in ws], K, tma=m.tma_ok(a) and all(m.tma_ok(wi) for wi in ws),
                       epilogue_aligned=m.aligned16(bias) and m.aligned16(resid))
    assert plan["body"] == ("wgmma" if case == "aligned" else "mma.sync")
    bodies = _bodies("gemm")
    out = m.gemm_wg(a, ws, *args)
    ref = m.gemm_plain(a, ws, *args)
    torch.cuda.synchronize()
    after = _bodies("gemm")
    want = {"wgmma": 1, "mma.sync": 0} if plan["body"] == "wgmma" else {"wgmma": 0, "mma.sync": len(ws)}
    assert {k: after[k] - bodies[k] for k in after} == want
    for o, r in zip(out, ref):
        assert (o.float() - r.float()).abs().max().item() <= _tol(torch.bfloat16, r)


def test_gemm_wg_repeats_bit_for_bit(dev):
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(44)
    a, w, (bias, resid, fs, fb, L) = _wg_case(g, dev, 3600, 512, 1024)
    one = m.gemm_wg(a, w, "bias_film_t", bias, resid, fs, fb, L)
    two = m.gemm_wg(a, w, "bias_film_t", bias, resid, fs, fb, L)
    assert torch.equal(one, two)


def _k8_args(g, dev, dtype, d, L_=37, b=2):
    s, bb = 1 + _rnd(g, dev, d, std=0.1), _rnd(g, dev, d, std=0.1)
    w = lambda: _rnd(g, dev, d, d, std=d**-0.5).to(dtype)
    return _rnd(g, dev, b, L_, d).to(dtype), s, bb, angle_table(L_, d, dev), w(), w(), w()


def _flat(o):
    return [t for part in (o if isinstance(o, tuple) else (o,)) for t in (part if isinstance(part, tuple) else (part,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d, l", [(64, 37), (512, 37), (512, 450)])
@pytest.mark.parametrize("form", ["apart", "joined", "rot-only", "rot-only apart"])
def test_ln_rotary_matmul_new_design_matches_plain(dev, dtype, d, l, form):
    """K8 in both forms with q's and k's weights apart and joined: bf16 the
    row body and one launch of the wgmma body for every product (no
    mma.sync launch); f32 the FMA sequence."""
    from tcdiff_torch.ops import ln_rotary_matmul as m

    g = torch.Generator(device=dev).manual_seed(45)
    x, s, bb, ang, wq, wk, wv = _k8_args(g, dev, dtype, d, l)
    w_rot = {"apart": (wq, wk), "joined": torch.cat([wq, wk]), "rot-only": wq, "rot-only apart": (wq, wk)}[form]
    w_plain = wv if form in ("apart", "joined") else None
    before, bodies = m.ln_rotary_matmul.launches, _bodies("ln_rotary_matmul")
    out = _flat(m.ln_rotary_matmul(x, s, bb, ang, w_rot, w_plain))
    ref = _flat(m.ln_rotary_matmul_plain(x, s, bb, ang, w_rot, w_plain))
    torch.cuda.synchronize()
    after = _bodies("ln_rotary_matmul")
    assert m.ln_rotary_matmul.launches == before + 1
    if dtype == torch.bfloat16:
        assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == (1, 0)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == dtype and o.shape == r.shape
        assert (o.float() - r.float()).abs().max().item() <= _tol(dtype, r)


@pytest.mark.parametrize("d", [96, 1024])
def test_ln_rotary_matmul_other_widths(dev, d):
    """d = 96 (no templated row width) and d = 1024: the row body, then the
    products on wgmma."""
    from tcdiff_torch.ops import ln_rotary_matmul as m

    g = torch.Generator(device=dev).manual_seed(46)
    x, s, bb, ang, wq, wk, wv = _k8_args(g, dev, torch.bfloat16, d)
    bodies = _bodies("ln_rotary_matmul")
    out = _flat(m.ln_rotary_matmul(x, s, bb, ang, (wq, wk), wv))
    ref = _flat(m.ln_rotary_matmul_plain(x, s, bb, ang, (wq, wk), wv))
    torch.cuda.synchronize()
    after = _bodies("ln_rotary_matmul")
    assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == (1, 0)
    for o, r in zip(out, ref):
        assert (o.float() - r.float()).abs().max().item() <= _tol(torch.bfloat16, r)


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("b, l, d, ff", [(2, 100, 128, 256), (8, 450, 512, 1024), (2, 37, 64, 96)])
def test_ff_block_new_design_matches_plain(dev, film, b, l, d, ff):
    """K2b in bf16: the row body, then both products on wgmma (no mma.sync
    launch)."""
    g = torch.Generator(device=dev).manual_seed(47)
    bf16 = torch.bfloat16
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    args = (r(b, l, d).to(bf16), 1 + r(d, std=0.1), r(d, std=0.1), r(ff, d, std=d**-0.5).to(bf16), r(ff, std=0.1),
            r(d, ff, std=ff**-0.5).to(bf16), r(d, std=0.1),
            *((r(b, d, std=0.1), r(b, d, std=0.1)) if film else (None, None)))
    bodies = _bodies("ff_block")
    out = ff_block.ff_block(*args)
    ref = ff_block.ff_block_plain(*args)
    torch.cuda.synchronize()
    after = _bodies("ff_block")
    assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == (2, 0)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(bf16, ref)


@pytest.mark.parametrize("case", ["bias 4 bytes off", "w 2 bytes off", "N % 8 != 0", "d % 8 != 0"])
def test_ln_matmul_off_the_rule_runs_on_mma(dev, case):
    """K9 in bf16 with an operand the wgmma body does not take: a bias 4
    bytes off a 16-byte boundary, a weight 2 bytes off, N % 8 != 0 (the
    output's rows off 16 bytes) or d % 8 != 0 (TMA's rows): its product on
    mma.sync (the per-body counts, as gemm_plan says), and it agrees with
    the plain version."""
    from tcdiff_torch.ops import gemm
    from tcdiff_torch.ops import ln_matmul as m

    g = torch.Generator(device=dev).manual_seed(50)
    d = 100 if case == "d % 8 != 0" else 64
    n = 50 if case == "N % 8 != 0" else 96
    x, s, bb, w, bias = _k9_args(g, dev, torch.bfloat16, d, n, l=37)
    if case == "bias 4 bytes off":
        bias = torch.cat([bias[:1], bias])[1:]
    if case == "w 2 bytes off":
        buf = torch.empty(n * d + 8, device=dev, dtype=torch.bfloat16)
        w = buf[1:1 + n * d].view(n, d).copy_(w)
    plan = gemm.gemm_plan(x.numel() // d, [n], d, tma=gemm.tma_ok(w), epilogue_aligned=gemm.aligned16(bias))
    assert plan["body"] == "mma.sync"
    bodies = _bodies("ln_matmul")
    out = m.ln_matmul(x, s, bb, w, bias)
    ref = m.ln_matmul_plain(x, s, bb, w, bias)
    torch.cuda.synchronize()
    after = _bodies("ln_matmul")
    assert (after["wgmma"] - bodies["wgmma"], after["mma.sync"] - bodies["mma.sync"]) == (0, 1)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)
    assert (out != ref).float().mean().item() <= 0.01


def _device_names(fn, want):
    """The device kernels of one fn() under torch.profiler, read again
    (three times at most, after a growing pause) while a reading holds
    other than `want`. A session drops its first device events, several
    in each session late in a long process (chip_smoke.device_kernels), so
    each starts with a pause and 32 short spin kernels that take the loss
    and are left out of the reading."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.01)
            for _ in range(32):
                torch.cuda._sleep(10_000)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False) and "#" not in e.name
                 and "spin_kernel" not in e.name]
        if len(names) == want:
            break
        time.sleep(0.1 * 2**attempt)
    return names


def test_k8_and_k2b_launches_on_the_card(dev):
    """bf16 at the serving shape: one K8 call is the row kernel and one
    gemm_wg_kernel launch, one K2b call the row kernel and two, and no
    other device kernel (no mma.sync product, no PyTorch kernel)."""
    from tcdiff_torch.ops import ln_rotary_matmul as m

    g = torch.Generator(device=dev).manual_seed(48)
    x, s, bb, ang, wq, wk, wv = _k8_args(g, dev, torch.bfloat16, 512, 450, 8)
    names = _device_names(lambda: m.ln_rotary_matmul(x, s, bb, ang, (wq, wk), wv), 2)
    assert len(names) == 2 and sum("gemm_wg_kernel" in n for n in names) == 1, names
    assert sum("ln_rows_kernel" in n for n in names) == 1, names
    r = lambda *sh, std=1.0: _rnd(g, dev, *sh, std=std)
    args = (x, s, bb, r(1024, 512, std=512**-0.5).to(torch.bfloat16), r(1024, std=0.1),
            r(512, 1024, std=1024**-0.5).to(torch.bfloat16), r(512, std=0.1), r(8, 512, std=0.1), r(8, 512, std=0.1))
    names = _device_names(lambda: ff_block.ff_block(*args), 3)
    assert len(names) == 3 and sum("gemm_wg_kernel" in n for n in names) == 2, names
    assert sum("ln_rows_kernel" in n for n in names) == 1, names


@pytest.mark.parametrize("n", [1024, 512])
def test_k9_launches_on_the_card(dev, n):
    """bf16 at the serving shape (linear1 N = 1024, linear3 N = 512): one K9
    call is the row kernel and one gemm_wg_kernel launch, and no other
    device kernel (no mma.sync product, no PyTorch kernel)."""
    from tcdiff_torch.ops import ln_matmul as m

    g = torch.Generator(device=dev).manual_seed(51)
    x, s, bb, w, bias = _k9_args(g, dev, torch.bfloat16, 512, n, 8, 450)
    names = _device_names(lambda: m.ln_matmul(x, s, bb, w, bias), 2)
    assert len(names) == 2 and sum("gemm_wg_kernel" in k for k in names) == 1, names
    assert sum("ln_rows_kernel" in k for k in names) == 1, names


def test_wgmma_body_refuses_what_it_does_not_take(dev):
    from tcdiff_torch.ops import gemm as m

    bf16 = torch.bfloat16
    a, w = torch.zeros(16, 64, device=dev, dtype=bf16), torch.zeros(32, 64, device=dev, dtype=bf16)
    with pytest.raises(TypeError):  # bf16 only
        m.gemm_wg(a.float(), w.float())
    with pytest.raises(ValueError):  # four products
        m.gemm_wg(a, [w] * 4)
    with pytest.raises(ValueError):  # a bias over products of unequal N
        m.gemm_wg(a, [w, w[:16]], "bias", torch.zeros(32, device=dev))
    with pytest.raises(ValueError):  # K of w against a
        m.gemm_wg(a, torch.zeros(32, 48, device=dev, dtype=bf16))


# ---------------------------------------- K1 and K2 on the wgmma body
# K1's and K2's products on the wgmma + TMA body at the cells' widths (d
# 512, 8 x 64 heads, ff 1024) over 3 x 450 rows, which no 128-row tile
# divides: every product of a call on wgmma (q/k/v one launch, the fc and
# W2 LayerNorm folds one cluster launch each, W1, W3), none on mma.sync;
# then the fold alone (gemm_ln_wg) in each form against a plain f32
# product and LayerNorm with the same rounding points (gemm_ln_plain:
# mm_f32, ln_f32), bit for bit across two runs; then gemm_plan against the
# C rule (tcd_wg_plan, tcd_ln_wg_plan) over shapes and alignments.
CELL_D, CELL_H, CELL_FF = 512, 8, 1024


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("trpe", [False, True])
def test_sa_block_products_on_wgmma_at_the_cell_widths(dev, film, trpe):
    g = torch.Generator(device=dev).manual_seed(60)
    bf16, b, l, d = torch.bfloat16, 3, 450, CELL_D
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    ws = [r(o, i, std=i**-0.5).to(bf16) for o, i in ((d, d), (d, d), (d, d), (d, d))]
    args = (r(b, l, d).to(bf16), 1 + r(d, std=0.1), r(d, std=0.1), angle_table(l, d, dev), *ws,
            1 + r(d, std=0.1), r(d, std=0.1),
            r(10, d).to(bf16) if trpe else None,
            torch.randint(0, 12, (b, l, l), generator=g, device=dev) if trpe else None,
            r(b, d, std=0.1) if film else None, r(b, d, std=0.1) if film else None)
    bodies, attn = _bodies("sa_block"), _attn_bodies("sa_block")
    out = sa_block.sa_block(*args, nhead=CELL_H)
    ref = sa_block.sa_block_plain(*args, nhead=CELL_H)
    torch.cuda.synchronize()
    after = _bodies("sa_block")
    assert {k: after[k] - bodies[k] for k in after} == {"wgmma": 2, "mma.sync": 0}
    assert _bodies_since(attn, "sa_block") == _ran(bf16, d // CELL_H, trpe, 1)
    assert out.dtype == bf16 and out.shape == args[0].shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(bf16, ref)


def test_ff_tail_products_on_wgmma_at_the_cell_widths(dev):
    g = torch.Generator(device=dev).manual_seed(61)
    bf16, b, l, d, ff = torch.bfloat16, 3, 450, CELL_D, CELL_FF
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    args = (r(b, l, d).to(bf16), 1 + r(d, std=0.1), r(d, std=0.1), r(ff, d, std=d**-0.5).to(bf16), r(ff, std=0.1),
            r(d, ff, std=ff**-0.5).to(bf16), r(d, std=0.1), r(b, d, std=0.1), r(b, d, std=0.1),
            1 + r(d, std=0.1), r(d, std=0.1), r(d, d, std=d**-0.5).to(bf16), r(d, std=0.1))
    bodies = _bodies("ff_tail")
    out = ff_block.ff_tail(*args)
    ref = ff_block.ff_tail_plain(*args)
    torch.cuda.synchronize()
    after = _bodies("ff_tail")
    assert {k: after[k] - bodies[k] for k in after} == {"wgmma": 3, "mma.sync": 0}
    assert (out.float() - ref.float()).abs().max().item() <= _tol(bf16, ref)


LN_FOLD_FORMS = ["post", "post with FiLM", "film_pre", "post then LN2", "post with FiLM then LN2 and rotary"]


def _ln_fold_case(g, dev, form, M, N, K, L):
    bf16 = torch.bfloat16
    r = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    a, w = r(M, K).to(bf16), r(N, K, std=K**-0.5).to(bf16)
    film = form != "post" and form != "post then LN2"
    kw = dict(eps=1e-6, form="film_pre" if form == "film_pre" else "post", L=L,
              prod_bias=r(N, std=0.1) if form == "film_pre" else None,
              resid=r(M, N).to(bf16) if film else None,
              film_scale=r(M // L, N, std=0.1) if film else None, film_shift=r(M // L, N, std=0.1) if film else None)
    if "LN2" in form:
        kw["next_ln"] = (1 + r(N, std=0.1), r(N, std=0.1), 1e-5, angle_table(L, N, dev) if "rotary" in form else None)
    return (a, w, 1 + r(N, std=0.1), r(N, std=0.1)), kw


@pytest.mark.parametrize("form", LN_FOLD_FORMS)
@pytest.mark.parametrize("M, L", [(1, 1), (1350, 450), (3600, 450)])
@pytest.mark.parametrize("N, K", [(512, 512), (512, 1024), (128, 64), (1024, 512), (96, 200)])
def test_ln_fold_wg_matches_plain(dev, form, M, L, N, K):
    """The fold on wgmma (one cluster launch, no mma.sync) against
    gemm_ln_plain; mma.sync's gemm_ln within the same bound; wgmma bit for
    bit across two runs."""
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(62)
    args, kw = _ln_fold_case(g, dev, form, M, N, K, L)
    bodies = _bodies("gemm")
    out = m.gemm_ln_wg(*args, **kw)
    torch.cuda.synchronize()
    after = _bodies("gemm")
    assert {k: after[k] - bodies[k] for k in after} == {"wgmma": 1, "mma.sync": 0}
    again = m.gemm_ln_wg(*args, **kw)
    old = m.gemm_ln(*args, **kw)
    ref = m.gemm_ln_plain(*args, **kw)
    outs, agains, olds, refs = (list(t) if isinstance(t, tuple) else [t] for t in (out, again, old, ref))
    assert len(outs) == len(refs) == (2 if "LN2" in form else 1)
    for o, a2, o2, r in zip(outs, agains, olds, refs):
        assert o.dtype == torch.bfloat16 and o.shape == (M, N) and torch.isfinite(o).all().item()
        assert torch.equal(o, a2)
        assert (o.float() - r.float()).abs().max().item() <= _tol(torch.bfloat16, r)
        assert (o2.float() - r.float()).abs().max().item() <= _tol(torch.bfloat16, r)


@pytest.mark.parametrize("case", ["N % 8 != 0", "a 2 bytes off", "resid 4 bytes off"])
def test_ln_fold_off_the_rule_runs_on_mma(dev, case):
    """A fold the wgmma body does not take runs on gemm_ln (mma.sync, which
    takes a residual 4-byte aligned), as gemm_plan says, and agrees with
    the plain version."""
    from tcdiff_torch.ops import gemm as m

    g = torch.Generator(device=dev).manual_seed(63)
    M, L, K = 900, 450, 128
    N = 100 if case == "N % 8 != 0" else 128
    args, kw = _ln_fold_case(g, dev, "post with FiLM", M, N, K, L)
    a = args[0]
    if case == "a 2 bytes off":
        a = torch.empty(M * K + 1, device=dev, dtype=a.dtype)[1:].view(M, K).copy_(a)
    if case == "resid 4 bytes off":
        kw["resid"] = torch.empty(M * N + 2, device=dev, dtype=a.dtype)[2:].view(M, N).copy_(kw["resid"])
    plan = m.gemm_plan(M, [N], K, tma=m.tma_ok(a), epilogue_aligned=m.aligned16(kw["resid"]), ln_fold=True)
    assert plan["body"] == "mma.sync"
    bodies = _bodies("gemm")
    out = m.gemm_ln_wg(a, *args[1:], **kw)
    torch.cuda.synchronize()
    after = _bodies("gemm")
    assert {k: after[k] - bodies[k] for k in after} == {"wgmma": 0, "mma.sync": 1}
    ref = m.gemm_ln_plain(a, *args[1:], **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)


PLAN_NS = [[512], [512, 512, 512], [1024, 512], [40], [50], [512, 49], [8, 96, 200]]
FOLD_NS = [128, 512, 1024, 1032, 1152, 100, 40]


@pytest.mark.parametrize("K", [64, 100, 512, 1024])
def test_gemm_plan_is_the_c_rule(dev, K):
    """ops/gemm.gemm_plan and the C code's decision (tcd_wg_plan,
    tcd_ln_wg_plan) agree at every shape and alignment of the grid: A or W
    2 or 8 bytes off 16, an output, the bias, the residual or a FiLM row 4
    bytes off, N and K off their multiples of 8, a fold's row past a
    cluster."""
    from tcdiff_torch.ops import gemm as m

    base = 1 << 20
    offsets = [0, 2, 4, 8]
    checked = 0
    for ns in PLAN_NS:
        for oa in offsets:
            for ow in offsets:
                for name in (None, "c0", "bias", "resid", "fs", "fb"):
                    addrs = {f"a{i}": base * (1 + i) + oa for i in range(len(ns))}
                    addrs.update({f"w{i}": base * (5 + i) + ow for i in range(len(ns))})
                    addrs.update({f"c{i}": base * (9 + i) for i in range(len(ns))})
                    addrs.update(bias=base * 13, resid=base * 14, fs=base * 15, fb=base * 16)
                    if name:
                        addrs[name] += 4
                    plan = m.gemm_plan(128, ns, K, tma=oa % 16 == 0 and ow % 16 == 0, epilogue_aligned=name is None)
                    assert m.c_body(ns, K, addrs) == plan["body"], (ns, K, oa, ow, name)
                    checked += 1
    for n in FOLD_NS:
        for oa in offsets:
            for name in (None, "out", "out2", "resid", "cos", "s", "b2", "bias", "fs"):
                names = ("w", "out", "out2", "resid", "cos", "ssin", "s", "b", "s2", "b2", "bias", "fs", "fb")
                addrs = {k: base * (2 + i) for i, k in enumerate(names)}
                addrs["a"] = base + oa
                if name:
                    addrs[name] += 4
                plan = m.gemm_plan(128, [n], K, tma=oa % 16 == 0, epilogue_aligned=name is None, ln_fold=True)
                assert m.c_body([n], K, addrs, ln_fold=True) == plan["body"], (n, K, oa, name)
                checked += 1
    assert checked == len(PLAN_NS) * len(offsets) ** 2 * 6 + len(FOLD_NS) * len(offsets) * 9


def test_dbn_window_matches_cpu(dev):
    """One full-width DBN window on the card against the same weights on
    the CPU, f32, at b = 3 (its LSTM recurs over the batch), within 1e-5 of
    the largest output."""
    cpu = TrajDecoder(TrajDecoderConfig(), device="cpu").init_random(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(1)
    x, music = 0.5 * torch.randn((3, 3, 100, 2), generator=g), torch.randn((3, 250, 438), generator=g)
    ref = cpu(x, music)
    out = card(x.to(dev), music.to(dev))
    assert out.device.type == "cuda"
    assert (out.cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_process_batch_matches_cpu(dev):
    """The dataset's processing (Y-up -> Z-up, FK, contacts, 6D packing) on
    the card against the CPU on the same seeded raw slices: the 147
    non-contact channels within 1e-5, the contacts equal wherever the CPU's
    foot velocity lies more than 1e-5 from the 0.01 threshold; chunked
    equal to whole on the card."""
    from tcdiff_torch.data import dataset as ds
    from tcdiff_torch.data.synthetic import synthetic_motion

    pos, q = synthetic_motion(8, 3, 150, seed=0)
    pos, q = torch.from_numpy(pos), torch.from_numpy(q.reshape(8, 3, 150, 24, 3))
    ref = ds._process_batch(pos, q)
    out = ds._process_batch(pos.to(dev), q.to(dev))
    assert torch.equal(ds._process_batch(pos.to(dev), q.to(dev), chunk=3), out)
    out = out.cpu()
    assert (out[..., 4:] - ref[..., 4:]).abs().max().item() <= 1e-5
    root = ds.quaternion_to_axis_angle(ds.quat_multiply(torch.as_tensor(ds._YUP_TO_ZUP_QUAT),
                                                        ds.axis_angle_to_quaternion(q[..., 0, :])))
    vel = ds._foot_velocity(ds.smpl_fk(torch.cat([root[..., None, :], q[..., 1:, :]], dim=-2),
                                       ds.rotate_points_x90(pos)))
    band = (vel - ds.CONTACT_VELOCITY).abs() <= 1e-5
    assert not ((out[..., :4] != ref[..., :4]) & ~band).any()


def _fk_joints(n: int, dn: int, t: int, seed: int) -> torch.Tensor:
    """(n, dn, t, 24, 3) FK joints of seeded smooth motion (Z-up after the
    dataset's rotation is not needed: the metrics take any joints)."""
    from tcdiff_torch.data.synthetic import synthetic_motion
    from tcdiff_torch.geometry.skeleton import smpl_fk

    pos, q = synthetic_motion(n, dn, t, seed=seed)
    return smpl_fk(torch.from_numpy(q.reshape(n, dn, t, 24, 3)), torch.from_numpy(pos))


def test_metrics_match_cpu(dev):
    """The eval metrics of 8 groups of 3 dancers x 150 frames on the card
    against the CPU: the kinetic features within 1e-5 of their largest
    value; the geometric feature matrices equal wherever the CPU's margin
    lies farther than MARGIN_BAND from its threshold; the report's other
    values within 1e-4 relative, and FID_g and diversity_g equal where no
    feature flipped."""
    from tcdiff_torch.eval import geometric as geo
    from tcdiff_torch.eval import metrics as met

    gen, ref = _fk_joints(8, 3, 150, 0), _fk_joints(8, 3, 150, 1)
    kin_cpu = met.kinetic_features(gen)
    kin = met.kinetic_features(gen.to(dev))
    assert kin.device.type == "cuda"
    assert (kin.cpu() - kin_cpu).abs().max().item() <= 1e-5 * kin_cpu.abs().max().item()
    margins = geo.geometric_feature_margins(gen)
    frames = geo.geometric_feature_frames(gen.to(dev))
    assert geo.flips_off_band(frames, margins > 0, margins) == 0
    flips = int((frames.cpu() != (margins > 0)).sum())
    music = [torch.randn((301, 438), generator=torch.Generator().manual_seed(i)).numpy() for i in range(8)]
    want = met.evaluate(gen, ref, music_feats=music, gen_roots=gen[..., 0, :])
    got = met.evaluate(gen.to(dev), ref.to(dev), music_feats=music, gen_roots=gen[..., 0, :].to(dev))
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("fid_g", "div_g"):
            assert flips or got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
        else:
            assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-9), k


def test_stitch_long_matches_cpu(dev):
    from tcdiff_torch.viz.postprocess import stitch_long

    g = torch.Generator().manual_seed(2)
    pos, q = torch.randn((5, 150, 3, 3), generator=g), torch.randn((5, 150, 3, 24, 3), generator=g)
    fp, fq = stitch_long(pos, q)
    dp, dq = stitch_long(pos.to(dev), q.to(dev))
    assert dq.device.type == "cuda" and dp.shape == fp.shape == (450, 3, 3)
    assert (dp.cpu() - fp).abs().max().item() <= 1e-5 * fp.abs().max().item()
    assert (dq.cpu() - fq).abs().max().item() <= 1e-5 * fq.abs().max().item()


def test_sharded_long_sampler_two_gloo_ranks_on_one_card(dev, tmp_path):
    """`long_ddim_sample_sharded` over two gloo ranks on this one card (NCCL
    refuses two ranks on one device), so that the neighbour exchange goes
    through the host copy of `parallel.comm`: 4 and 2 slices against
    `long_ddim_sample` in one process on the same card, through K1/K2 in
    f32, within 1e-5 (the same kernels at another batch); the generator
    case too."""
    import _torch_parallel as tp
    from tcdiff_torch.ops import _build

    _build.build_all(["sa_block", "ff_tail"])  # once, before the ranks load them
    model = dict(tp.LONG_MODEL, latent_dim=128, ff_size=256, head_dim=64)
    payload = tp.long_payload(None, model=model)
    ranks = tp.run_ranks("long_sampler", tmp_path, payload, device="cuda:0")
    ref = tp.long_sampler_plain(payload, device=dev)
    for key in (4, 2, "generator"):
        for r, res in enumerate(ranks):
            got = res[key] if key == "generator" else res[key]["full"]
            assert (got - ref[key]).abs().max().item() <= 1e-5, (key, r)
