"""The products of the hand-written kernels alone, for tests and
measurement, in the three layouts of a linear layer y = x . W^T (W in
nn.Linear layout (N, K)):

    gemm     C = A . W^T with a fused epilogue       the forward projection
    gemm_nn  C = A . B, B (K, N) (W read as (K, N))  the input gradient
    wgrad    dW = G^T . X over the rows              the weight gradient

`csrc/gemm.cu` exposes the products of `csrc/gemm_mma.cuh` that every
kernel runs: bf16 on the tensor cores (mma.sync), f32 on the FMA tiles.
No path of the model calls this module; `chip_smoke.py` times K1's, K2's,
K3's and K5's products through it and `tests/test_torch_cuda.py` holds it
against the plain versions.

Epilogues of `gemm`, with acc the f32 sum and T the dtype of a:

    store      T(acc)
    store_f32  acc
    bias       T(acc + bias)
    bias_gelu  T(gelu_erf(acc + bias))
    bias_film  resid + (fs[m // L] + 1) * (acc + bias) + fb[m // L], in f32
    bias_rounded  T(T(acc) + T(bias)): the product rounded before the bias (K9)

a (M, K), w (N, K), bias (N,) f32, resid (M, N) in T, film rows
(M / L, N). A list of up to three a and as many w that share M, N and K
is the grouped form (K1's q/k/v): one launch, a list of outputs; bias and
the FiLM arguments are shared by the group.

`gemm_nn` takes store, store_f32 or acc_f32 (out += acc, out an f32
(M, N) given), and a list of two a and two b of one shape for the joined
form: one launch, C = a0 . b0 + a1 . b1 in one f32 sum (K3's dr).
`wgrad` (g (R, N), x (R, K)) sums f32 partials of row chunks in chunk
order and rounds to T; `splits` chunks where given, else as the train
kernels cut them (`train_common.weight_splits`); lists of up to three g
and as many x over the same rows are one launch (K4's dWk and dWv).

Two more bodies, bf16 only (in f32 the kernels keep the unfused
sequences, and these entries raise):

    gemm_nn_rot  C = rot^T(a0 . b0) + a1 . b1   K4's memory cotangent
    gemm_lnrot   C = rot(LN(x)) . W^T            K7's q projection

rot^T(g) = g*cos + swap_pairs(g*ssin) and rot(y) = y*cos + swap_pairs(y)*ssin
with the tables of an angle table (L, N or d) at row m % L.

The forward projection on the wgmma + TMA body (`csrc/gemm_wgmma.cuh`),
bf16 only, which K1's, K2's, K2b's, K8's and K9's products run, and the
LayerNorm after a product in its epilogue (K1's and K7's fc, K2's W2):

    gemm_wg      C[g] = A[g] . W[g]^T, up to three products of one launch,
                 each with its own N (and A), the epilogues above and
                 bias_film_t = T(bias_film)
    gemm_ln_wg   out = T(LN(A . W^T)) [+ FiLM residual], or
    gemm_ln      T(LN(resid + (fs+1) * (A . W^T + bias) + fb)); optionally
                 a second LayerNorm on out (K6's): gemm_ln_wg on the wgmma
                 body by its rule, gemm_ln always on mma.sync

`gemm_plan` is the dispatch rule written out (which body a product or a
fold runs, its grid and waves), `c_body` the rule as the C code decides it
(`tcd_wg_plan`, `tcd_ln_wg_plan`), `body_launches` the per-body launch
counts of a library and `tma_stats` the host time its tensor maps took.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops import _build
from tcdiff_torch.ops._common import (LN_FOLD_MAX_D, args_struct, as_t, check_cuda, check_ln_fold, launch, ln_f32,
                                      mm_f32)
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables
from tcdiff_torch.ops.train_common import weight_splits

EPILOGUES = {"store": 0, "store_f32": 1, "bias": 2, "bias_gelu": 3, "bias_film": 4, "bias_rounded": 7}  # tcd::Epi
WG_EPILOGUES = dict(EPILOGUES, bias_film_t=8)
NN_EPILOGUES = {"store": 0, "store_f32": 1, "acc_f32": 5}
LAYOUT_FWD, LAYOUT_NN, LAYOUT_WGRAD = 0, 1, 2  # GemmArgs.layout
F32_OUT = ("store_f32", "bias_film")
GROUP_MAX = 3


def _epilogue_plain(acc, dt, epilogue, bias, resid, film_scale, film_shift, L):
    if epilogue == "bias_rounded":
        return acc.to(dt) + bias.to(dt)
    if epilogue != "store" and epilogue != "store_f32":
        acc = acc + bias.float()
    if epilogue == "store_f32":
        return acc
    if epilogue in ("bias_film", "bias_film_t"):
        rows = lambda t: t.float().repeat_interleave(L, dim=0)
        acc = resid.float() + (rows(film_scale) + 1.0) * acc + rows(film_shift)
        return acc if epilogue == "bias_film" else acc.to(dt)
    if epilogue == "bias_gelu":
        acc = F.gelu(acc)
    return acc.to(dt)


def gemm_plain(a, w, epilogue: str = "store", bias=None, resid=None, film_scale=None, film_shift=None,
               L: int = 1):
    """Plain PyTorch version of gemm and gemm_wg: mm_f32 and the epilogue in
    f32; the oracle. w a list: one output per w, with a[i] (a list) or the
    one a."""
    grouped = isinstance(w, (list, tuple))
    ws = list(w) if grouped else [w]
    as_ = list(a) if isinstance(a, (list, tuple)) else [a] * len(ws)
    outs = [_epilogue_plain(mm_f32(ai, wi), ai.dtype, epilogue, bias, resid, film_scale, film_shift, L)
            for ai, wi in zip(as_, ws)]
    return outs if grouped else outs[0]


_Args = args_struct(  # GemmArgs in csrc/gemm.cu
    "GemmArgs",
    ("a0", "a1", "a2", "w0", "w1", "w2", "c0", "c1", "c2", "bias", "resid", "fs", "fb", "part"),
    ("M", "N", "K", "L", "epi", "groups", "layout", "splits", "cap"),
    (),
)


def _gemm_cuda(a, w, epilogue, bias, resid, film_scale, film_shift, L):
    x = a[0]
    check_cuda(x, bias=bias, resid=resid, film_scale=film_scale, film_shift=film_shift)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {sorted(EPILOGUES)}")
    if not 1 <= len(a) <= GROUP_MAX or len(w) != len(a):
        raise ValueError(f"give 1 to {GROUP_MAX} a and as many w, got {len(a)} and {len(w)}")
    if x.dim() != 2:
        raise ValueError(f"a must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = w[0].shape[0]
    for ai, wi in zip(a, w):
        check_cuda(ai, w=wi)
        if ai.dtype != x.dtype or tuple(ai.shape) != (M, K) or tuple(wi.shape) != (N, K):
            raise ValueError(f"a group shares dtype, a (M, K) = {(M, K)} and w (N, K) = {(N, K)}")
    if epilogue not in ("store", "store_f32") and (bias is None or tuple(bias.shape) != (N,)):
        raise ValueError(f"epilogue {epilogue} needs bias (N,) = ({N},)")
    if epilogue == "bias_film":
        if M % L or resid is None or tuple(resid.shape) != (M, N):
            raise ValueError(f"bias_film needs resid (M, N) = {(M, N)} and L dividing M = {M}")
        for name, t in (("film_scale", film_scale), ("film_shift", film_shift)):
            if t is None or tuple(t.shape) != (M // L, N):
                raise ValueError(f"bias_film needs {name} (M / L, N) = {(M // L, N)}")

    dt = x.dtype
    out_dt = torch.float32 if epilogue in F32_OUT else dt
    outs = [torch.empty((M, N), dtype=out_dt, device=x.device) for _ in a]
    ten = {}
    for i, (ai, wi, ci) in enumerate(zip(a, w, outs)):
        ten.update({f"a{i}": ai, f"w{i}": as_t(wi, dt), f"c{i}": ci})
    if bias is not None and epilogue not in ("store", "store_f32"):
        ten["bias"] = bias.float().contiguous()
    if epilogue == "bias_film":
        ten.update(resid=as_t(resid, dt), fs=film_scale.float().contiguous(), fb=film_shift.float().contiguous())
    dims = dict(M=M, N=N, K=K, L=L, epi=EPILOGUES[epilogue], groups=len(a), layout=LAYOUT_FWD)
    launch("gemm", "tcd_gemm", _Args, ten, dims, x, "gemm")
    gemm.launches += 1
    return outs


def gemm(a, w, epilogue: str = "store", bias=None, resid=None, film_scale=None, film_shift=None, L: int = 1):
    """C = a . w^T with the epilogue: the CUDA kernel for a CUDA a, the
    plain version for a CPU a. a and w are tensors, or lists of up to three
    (the grouped form, one launch). See the module docstring."""
    grouped = isinstance(a, (list, tuple))
    first = a[0] if grouped else a
    if first.device.type == "cpu":
        return gemm_plain(a, w, epilogue, bias, resid, film_scale, film_shift, L)
    if first.device.type != "cuda":
        raise ValueError(f"gemm runs on CPU or CUDA tensors, got {first.device}")
    outs = _gemm_cuda(list(a) if grouped else [a], list(w) if grouped else [w], epilogue, bias, resid,
                      film_scale, film_shift, L)
    return outs if grouped else outs[0]


gemm.launches = 0  # kernel launches; the plain path does not count


# ------------------------------------------------------------ input gradient
def gemm_nn_plain(a, b, epilogue: str = "store", out=None):
    """Plain version of gemm_nn: f32 products and sums (b rounded to a's
    dtype first), the joined pairs added in f32, cast as the kernel casts."""
    a, b = (a, b) if isinstance(a, (list, tuple)) else ([a], [b])
    acc = sum(ai.float() @ bi.to(ai.dtype).float() for ai, bi in zip(a, b))
    if epilogue == "acc_f32":
        return out.add_(acc)
    return acc if epilogue == "store_f32" else acc.to(a[0].dtype)


def _gemm_nn_cuda(a, b, epilogue, out):
    x = a[0]
    check_cuda(x, out=out)
    if epilogue not in NN_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {sorted(NN_EPILOGUES)}")
    if not 1 <= len(a) <= 2 or len(b) != len(a):
        raise ValueError(f"give 1 or 2 a and as many b, got {len(a)} and {len(b)}")
    if x.dim() != 2:
        raise ValueError(f"a must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = b[0].shape[1]
    for ai, bi in zip(a, b):
        check_cuda(ai, b=bi)
        if ai.dtype != x.dtype or tuple(ai.shape) != (M, K) or tuple(bi.shape) != (K, N):
            raise ValueError(f"the pairs share dtype, a (M, K) = {(M, K)} and b (K, N) = {(K, N)}")
    if epilogue == "acc_f32":
        if out is None or out.dtype != torch.float32 or tuple(out.shape) != (M, N) or not out.is_contiguous():
            raise ValueError(f"acc_f32 adds into a contiguous f32 out of shape {(M, N)}")
    else:
        out = torch.empty((M, N), dtype=torch.float32 if epilogue == "store_f32" else x.dtype, device=x.device)
    ten = {"c0": out}
    for i, (ai, bi) in enumerate(zip(a, b)):
        ten.update({f"a{i}": ai, f"w{i}": as_t(bi, x.dtype)})
    dims = dict(M=M, N=N, K=K, L=1, epi=NN_EPILOGUES[epilogue], groups=len(a), layout=LAYOUT_NN)
    launch("gemm", "tcd_gemm", _Args, ten, dims, x, "gemm_nn")
    gemm_nn.launches += 1
    return out


def gemm_nn(a, b, epilogue: str = "store", out=None):
    """C = a . b (a (M, K), b (K, N)), the input gradient's product: the
    CUDA kernel for a CUDA a, the plain version for a CPU a. Lists of two a
    and two b: the joined form. acc_f32 adds into `out` and returns it."""
    first = a[0] if isinstance(a, (list, tuple)) else a
    if first.device.type == "cpu":
        return gemm_nn_plain(a, b, epilogue, out)
    if first.device.type != "cuda":
        raise ValueError(f"gemm_nn runs on CPU or CUDA tensors, got {first.device}")
    grouped = isinstance(a, (list, tuple))
    return _gemm_nn_cuda(list(a) if grouped else [a], list(b) if grouped else [b], epilogue, out)


gemm_nn.launches = 0


# ----------------------------------------------------------- weight gradient
def wgrad_plain(g, x):
    """Plain version of wgrad: g^T . x in f32, rounded to g's dtype (lists:
    one each)."""
    if isinstance(g, (list, tuple)):
        return [wgrad_plain(gi, xi) for gi, xi in zip(g, x)]
    return (g.float().t() @ x.float()).to(g.dtype)


def wgrad(g, x, splits: int | None = None):
    """dW (N, K) = g^T . x for g (R, N), x (R, K): the CUDA kernel (split
    rows, f32 partials added in chunk order, then rounded) for a CUDA g,
    the plain version for a CPU g. Lists of up to three g and as many x of
    one shape: one launch, a list of gradients."""
    grouped = isinstance(g, (list, tuple))
    gs, xs = (list(g), list(x)) if grouped else ([g], [x])
    if gs[0].device.type == "cpu":
        return wgrad_plain(g, x)
    if gs[0].device.type != "cuda":
        raise ValueError(f"wgrad runs on CPU or CUDA tensors, got {gs[0].device}")
    if not 1 <= len(gs) <= GROUP_MAX or len(xs) != len(gs):
        raise ValueError(f"give 1 to {GROUP_MAX} g and as many x, got {len(gs)} and {len(xs)}")
    R, N = gs[0].shape
    K = xs[0].shape[1]
    for gi, xi in zip(gs, xs):
        check_cuda(gi, operand=xi)
        if (gi.dim() != 2 or xi.dim() != 2 or tuple(gi.shape) != (R, N) or tuple(xi.shape) != (R, K)
                or xi.dtype != gi.dtype or gi.dtype != gs[0].dtype or not xi.is_contiguous()):
            raise ValueError(f"g (R, N) and x (R, K) share R and dtype, got {tuple(gi.shape)} and {tuple(xi.shape)}")
    n = weight_splits(R, N, K, len(gs)) if splits is None else splits
    if n < 1:
        raise ValueError(f"splits must be at least 1, got {n}")
    part = torch.empty(len(gs) * n * N * K, dtype=torch.float32, device=gs[0].device)
    out = torch.empty((len(gs), N, K), dtype=gs[0].dtype, device=gs[0].device)
    ten = dict(c0=out, part=part)
    for i, (gi, xi) in enumerate(zip(gs, xs)):
        ten.update({f"a{i}": gi, f"w{i}": xi})
    dims = dict(M=R, N=N, K=K, L=1, epi=0, groups=len(gs), layout=LAYOUT_WGRAD, splits=n, cap=part.numel())
    launch("gemm", "tcd_gemm", _Args, ten, dims, gs[0], "wgrad")
    wgrad.launches += 1
    return list(out) if grouped else out[0]


wgrad.launches = 0


# ------------------------------------------- K4's memory cotangent, K7's q
def gemm_nn_rot_plain(a0, b0, a1, b1, angles):
    """Plain version of gemm_nn_rot: the products in f32 (b rounded to a's
    dtype), rot^T on the first in f32, one rounding at the end."""
    dt = a0.dtype
    cos, ssin = rotary_tables(angles, dt)
    rows = torch.arange(a0.shape[0], device=a0.device) % angles.shape[0]
    g = a0.float() @ b0.to(dt).float()
    g = g * cos.float()[rows] + swap_pairs(g * ssin.float()[rows])
    return (g + a1.float() @ b1.to(dt).float()).to(dt)


_RotArgs = args_struct(  # GemmRotArgs in csrc/gemm.cu
    "GemmRotArgs", ("a0", "w0", "a1", "w1", "cos", "ssin", "s", "b", "out"), ("M", "N", "K", "L"), ("eps",))


def _bf16_only(x, what: str) -> None:
    check_cuda(x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} is a bf16 kernel: in f32 the kernels keep the unfused sequence")


def gemm_nn_rot(a0, b0, a1, b1, angles):
    """C (M, N) = rot^T(a0 . b0) + a1 . b1 for a (M, K), b (K, N) (weights
    in nn.Linear layout read as (K, N)) and the angle table (L, N), row
    m % L: K4's d mem = rot_m^T(dk . Wk) + dv . Wv over its B Lm rows. The
    CUDA kernel (bf16, one launch) for a CUDA a0, the plain version for a
    CPU a0."""
    if a0.device.type == "cpu":
        return gemm_nn_rot_plain(a0, b0, a1, b1, angles)
    if a0.device.type != "cuda":
        raise ValueError(f"gemm_nn_rot runs on CPU or CUDA tensors, got {a0.device}")
    _bf16_only(a0, "gemm_nn_rot")
    M, K = a0.shape
    N = b0.shape[1]
    for name, t, shape in (("b0", b0, (K, N)), ("a1", a1, (M, K)), ("b1", b1, (K, N)),
                           ("angles", angles, (angles.shape[0], N))):
        check_cuda(a0, **{name: t})
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if N % 2:
        raise ValueError(f"N={N} must be even: the rotary pairs")
    cos, ssin = cached_rotary_tables(angles, a0.dtype)
    out = torch.empty((M, N), dtype=a0.dtype, device=a0.device)
    ten = dict(a0=a0, w0=as_t(b0, a0.dtype), a1=as_t(a1, a0.dtype), w1=as_t(b1, a0.dtype), cos=cos, ssin=ssin,
               out=out)
    launch("gemm", "tcd_gemm_nn_rot", _RotArgs, ten, dict(M=M, N=N, K=K, L=angles.shape[0]), a0, "gemm_nn_rot")
    gemm_nn_rot.launches += 1
    return out


gemm_nn_rot.launches = 0


def gemm_lnrot_plain(x, scale, bias, angles, w, eps: float = 1e-5):
    """Plain version of gemm_lnrot: LN and rotary in f32, rounded to x's
    dtype, then the product in f32 sums."""
    from tcdiff_torch.ops.sa_block_train import rot

    dt = x.dtype
    cos, ssin = rotary_tables(angles, dt)
    return mm_f32(rot(ln_f32(x, scale, bias, eps), cos, ssin).to(dt), w).to(dt)


def gemm_lnrot(x, scale, bias, angles, w, eps: float = 1e-5):
    """q = T(rot(LN(x; eps))) . w^T for x (b, L, d), the LayerNorm affine
    (d,), the angle table (L, d) and w (N, d): K7's q projection with the
    LayerNorm and the rotary in its prologue. The CUDA kernel (bf16, one
    launch) for a CUDA x, the plain version for a CPU x."""
    if x.device.type == "cpu":
        return gemm_lnrot_plain(x, scale, bias, angles, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_lnrot runs on CPU or CUDA tensors, got {x.device}")
    _bf16_only(x, "gemm_lnrot")
    check_cuda(x, scale=scale, bias=bias, angles=angles, w=w)
    B, L, d = x.shape
    N = w.shape[0]
    if d % 2 or N % 2:
        raise ValueError(f"d={d} and N={N} must be even")
    check_ln_fold(d, x.dtype)  # a block holds its rows whole: as many as a LayerNorm fold
    check_ln_fold(N, x.dtype)  # a cluster holds a row tile's N columns, as a fold's does
    for name, t, shape in (("scale", scale, (d,)), ("bias", bias, (d,)), ("angles", angles, (L, d)),
                           ("w", w, (N, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    cos, ssin = cached_rotary_tables(angles, x.dtype)
    out = torch.empty((B, L, N), dtype=x.dtype, device=x.device)
    ten = dict(a0=x, w0=as_t(w, x.dtype), cos=cos, ssin=ssin, s=as_t(scale, torch.float32),
               b=as_t(bias, torch.float32), out=out)
    launch("gemm", "tcd_gemm_lnrot", _RotArgs, ten, dict(M=B * L, N=N, K=d, L=L, eps=eps), x, "gemm_lnrot")
    gemm_lnrot.launches += 1
    return out


gemm_lnrot.launches = 0


# ------------------------------------------------- the wgmma + TMA body
WG_BM, WG_BN = 128, 128  # csrc/gemm_wgmma.cuh: WBM, WBN
SMS = 132                # the H100 SXM's SMs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def aligned16(t: torch.Tensor | None) -> bool:
    """Whether t's base is 16-byte aligned (None is)."""
    return t is None or t.data_ptr() % 16 == 0


def tma_ok(t: torch.Tensor | None) -> bool:
    """Whether TMA can read the row-major bf16 operand t: a 16-byte aligned
    base and a row stride of a multiple of 16 bytes (tcd::tma_ok)."""
    return t is None or (aligned16(t) and t.stride(-2 if t.dim() > 1 else 0) % 8 == 0 and t.stride(-1) == 1)


def gemm_plan(M: int, ns, K: int, tma: bool = True, epilogue_aligned: bool = True, ln_fold: bool = False) -> dict:
    """The dispatch rule of the bf16 forward projection, as csrc/gemm_wgmma.cuh
    applies it (gemm_wg, wg_ok), for C[g] = A[g] . W[g]^T with N = ns[g]:
    "wgmma", one launch of 128 x 128 tiles, where TMA takes every A and W
    (tma: 16-byte aligned bases; and K % 8 == 0) and the epilogue moves in
    16-byte pieces (every N % 8 == 0; epilogue_aligned: the outputs, bias,
    residual and FiLM rows 16-byte aligned); else "mma.sync", one launch
    per product. ln_fold: one product with the LayerNorm in its epilogue
    (gemm_ln_wg, ln_wg_ok), whose row a cluster of LN_FOLD_MAX_D / 128
    blocks must hold besides: "wgmma" where N <= LN_FOLD_MAX_D too, else
    "mma.sync" (gemm_ln, which refuses an odd N or one past
    LN_FOLD_MAX_D); one launch either way. The wrappers do not call it:
    the C code dispatches (`c_body` asks it).

    Returns dict(body, launches, tile (BM, BN), grid (x, y), blocks,
    waves): waves are blocks over the blocks the SMs hold at once (one an
    SM for wgmma, two for mma.sync)."""
    ns = list(ns)
    if ln_fold and len(ns) != 1:
        raise ValueError(f"a LayerNorm fold is one product, got N = {ns}")
    rows_fit = not ln_fold or 0 < ns[0] <= LN_FOLD_MAX_D
    if tma and K > 0 and K % 8 == 0 and epilogue_aligned and all(n % 8 == 0 for n in ns) and rows_fit:
        body, launches, per_sm = "wgmma", 1, 1
    else:
        body, launches, per_sm = "mma.sync", 1 if ln_fold else len(ns), 2
    grid = (sum(_cdiv(n, WG_BN) for n in ns), _cdiv(M, WG_BM))
    blocks = grid[0] * grid[1]
    return dict(body=body, launches=launches, tile=(WG_BM, WG_BN), grid=grid, blocks=blocks,
                waves=blocks / (SMS * per_sm))


_WgArgs = args_struct(  # GemmWgArgs in csrc/gemm.cu
    "GemmWgArgs",
    ("a0", "a1", "a2", "w0", "w1", "w2", "c0", "c1", "c2", "bias", "resid", "fs", "fb"),
    ("M", "K", "L", "epi", "groups", "n0", "n1", "n2"),
    (),
)


def gemm_wg(a, w, epilogue: str = "store", bias=None, resid=None, film_scale=None, film_shift=None, L: int = 1):
    """C[g] = a[g] . w[g]^T on the wgmma + TMA body (bf16; gemm_plan's rule:
    what the body does not take runs on mma.sync): the CUDA kernel for a
    CUDA operand, the plain version (gemm_plain) for a CPU one. w: a tensor
    (N, K) or a list of up to three with their own N; a: one (M, K) tensor
    shared by the group, or a list as long as w. Returns a tensor, or a
    list for a list w."""
    grouped = isinstance(w, (list, tuple))
    ws = list(w) if grouped else [w]
    as_ = list(a) if isinstance(a, (list, tuple)) else [a] * len(ws)
    x = as_[0]
    if x.device.type == "cpu":
        return gemm_plain(a, w, epilogue, bias, resid, film_scale, film_shift, L)
    if x.device.type != "cuda":
        raise ValueError(f"gemm_wg runs on CPU or CUDA tensors, got {x.device}")
    _bf16_only(x, "gemm_wg")
    check_cuda(x, bias=bias, resid=resid, film_scale=film_scale, film_shift=film_shift)
    if epilogue not in WG_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {sorted(WG_EPILOGUES)}")
    if not 1 <= len(ws) <= GROUP_MAX or len(as_) != len(ws):
        raise ValueError(f"give 1 to {GROUP_MAX} w and one a or as many, got {len(ws)} and {len(as_)}")
    if x.dim() != 2:
        raise ValueError(f"a must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    for ai, wi in zip(as_, ws):
        check_cuda(x, a=ai, w=wi)
        if ai.dtype != x.dtype or tuple(ai.shape) != (M, K) or wi.dim() != 2 or wi.shape[1] != K:
            raise ValueError(f"a group shares dtype and a (M, K) = {(M, K)}; w is (N, K)")
        if not (ai.is_contiguous() and wi.is_contiguous()):
            raise ValueError("a and w must be contiguous")
    ns = [wi.shape[0] for wi in ws]
    if epilogue not in ("store", "store_f32") and (bias is None or len(set(ns)) > 1 or tuple(bias.shape) != (ns[0],)):
        raise ValueError(f"epilogue {epilogue} needs bias (N,) and one N for the group, got {ns}")
    if epilogue.startswith("bias_film"):
        N = ns[0]
        if M % L or resid is None or tuple(resid.shape) != (M, N):
            raise ValueError(f"{epilogue} needs resid (M, N) = {(M, N)} and L dividing M = {M}")
        for name, t in (("film_scale", film_scale), ("film_shift", film_shift)):
            if t is None or tuple(t.shape) != (M // L, N):
                raise ValueError(f"{epilogue} needs {name} (M / L, N) = {(M // L, N)}")
    dt = x.dtype
    out_dt = torch.float32 if epilogue in F32_OUT else dt
    outs = [torch.empty((M, n), dtype=out_dt, device=x.device) for n in ns]
    ten = {}
    for i, (ai, wi, ci) in enumerate(zip(as_, ws, outs)):
        ten.update({f"a{i}": ai, f"w{i}": wi.to(dt) if wi.dtype != dt else wi, f"c{i}": ci})
    if epilogue not in ("store", "store_f32"):
        ten["bias"] = as_t(bias, torch.float32)
    if epilogue.startswith("bias_film"):
        ten.update(resid=as_t(resid, dt), fs=as_t(film_scale, torch.float32), fb=as_t(film_shift, torch.float32))
    dims = dict(M=M, K=K, L=L, epi=WG_EPILOGUES[epilogue], groups=len(ws), **{f"n{i}": n for i, n in enumerate(ns)})
    launch("gemm", "tcd_gemm_wg", _WgArgs, ten, dims, x, "gemm_wg")
    gemm_wg.launches += 1
    return outs if grouped else outs[0]


gemm_wg.launches = 0


# ------------------------------------------- the LayerNorm fold (bf16)
LN_FORMS = {"post": 0, "film_pre": 1}     # tcd::LnEpi: LN_POST, LN_FILM_PRE
LN2_FORMS = {None: 0, "plain": 1, "rot": 2}  # tcd::Ln2


def gemm_ln_plain(a, w, scale, bias, eps: float = 1e-5, form: str = "post", prod_bias=None, resid=None,
                  film_scale=None, film_shift=None, L: int = 1, next_ln=None):
    """Plain version of the LayerNorm fold (gemm_ln, gemm_ln_wg): the product
    in f32 (mm_f32), LN_FILM_PRE's FiLM residual in f32, ln_f32, LN_POST's
    FiLM residual in f32, rounded to a's dtype; next_ln = (scale2, bias2,
    eps2, angles or None): ln_f32 of the rounded output, rotated by the
    angle table's rows m % len(angles) where given, rounded. Returns out,
    or (out, out2) with next_ln."""
    dt = a.dtype
    rows = lambda t: t.float().repeat_interleave(L, dim=0)
    acc = mm_f32(a, w)
    if form == "film_pre":
        acc = resid.float() + (rows(film_scale) + 1.0) * (acc + prod_bias.float()) + rows(film_shift)
    y = ln_f32(acc, scale, bias, eps)
    if form == "post" and film_scale is not None:
        y = resid.float() + (rows(film_scale) + 1.0) * y + rows(film_shift)
    out = y.to(dt)
    if next_ln is None:
        return out
    s2, b2, eps2, angles = next_ln
    y2 = ln_f32(out, s2, b2, eps2)
    if angles is not None:
        cos, ssin = rotary_tables(angles, dt)
        r = torch.arange(a.shape[0], device=a.device) % angles.shape[0]
        y2 = y2 * cos.float()[r] + swap_pairs(y2) * ssin.float()[r]
    return out, y2.to(dt)


_LnArgs = args_struct(  # GemmLnArgs in csrc/gemm.cu
    "GemmLnArgs", ("a", "w", "resid", "cos", "ssin", "s", "b", "bias", "fs", "fb", "s2", "b2", "out", "out2"),
    ("M", "N", "K", "L", "lne", "ln2"), ("eps", "eps2"))


def _gemm_ln_cuda(fn_name, a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L, next_ln):
    _bf16_only(a, fn_name)
    check_cuda(a, w=w, scale=scale, bias=bias, prod_bias=prod_bias, resid=resid, film_scale=film_scale,
               film_shift=film_shift)
    if form not in LN_FORMS:
        raise ValueError(f"unknown form {form!r}; one of {sorted(LN_FORMS)}")
    if a.dim() != 2 or w.dim() != 2 or w.shape[1] != a.shape[1]:
        raise ValueError(f"a (M, K) and w (N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    N = w.shape[0]
    if N % 2:
        raise ValueError(f"N={N} must be even")
    check_ln_fold(N, a.dtype)
    film = film_scale is not None
    if form == "film_pre" and (prod_bias is None or not film):
        raise ValueError("film_pre needs the product's bias and the FiLM rows")
    for name, t, shape in (("scale", scale, (N,)), ("bias", bias, (N,)), ("prod_bias", prod_bias, (N,)),
                           ("resid", resid if film else None, (M, N)), ("film_scale", film_scale, (M // L, N)),
                           ("film_shift", film_shift, (M // L, N))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if film and (resid is None or film_shift is None or M % L):
        raise ValueError(f"FiLM rows need resid (M, N), both rows and L dividing M = {M}")
    f32 = lambda t: None if t is None else as_t(t, torch.float32)
    dt = a.dtype
    out = torch.empty((M, N), dtype=dt, device=a.device)
    ten = dict(a=a, w=as_t(w, dt), s=f32(scale), b=f32(bias), bias=f32(prod_bias), out=out)
    if film:
        ten.update(resid=as_t(resid, dt), fs=f32(film_scale), fb=f32(film_shift))
    ln2, eps2 = None, 0.0
    if next_ln is not None:
        s2, b2, eps2, angles = next_ln
        ln2 = "plain" if angles is None else "rot"
        out2 = torch.empty_like(out)
        ten.update(s2=f32(s2), b2=f32(b2), out2=out2)
        if angles is not None:
            if angles.dim() != 2 or angles.shape[1] != N or (film and angles.shape[0] != L):
                raise ValueError(f"angles must be (L, N) = ({L if film else 'L'}, {N}), got {tuple(angles.shape)}")
            ten["cos"], ten["ssin"] = cached_rotary_tables(angles, dt)
            L = angles.shape[0]
    ten = {k: t for k, t in ten.items() if t is not None}
    dims = dict(M=M, N=N, K=K, L=L, lne=LN_FORMS[form], ln2=LN2_FORMS[ln2], eps=eps, eps2=eps2)
    launch("gemm", f"tcd_{fn_name}", _LnArgs, ten, dims, a, fn_name)
    return out if next_ln is None else (out, out2)


def _ln_fold(fn_name, a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L, next_ln):
    if a.device.type == "cpu":
        return gemm_ln_plain(a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L, next_ln)
    if a.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on CPU or CUDA tensors, got {a.device}")
    return _gemm_ln_cuda(fn_name, a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L,
                         next_ln)


def gemm_ln_wg(a, w, scale, bias, eps: float = 1e-5, form: str = "post", prod_bias=None, resid=None,
               film_scale=None, film_shift=None, L: int = 1, next_ln=None):
    """The LayerNorm fold of a (M, K) . w^T (w (N, K)) as the blocks launch
    it (gemm_ln_wg of csrc/gemm_wgmma.cuh: the wgmma body by gemm_plan's
    rule with ln_fold, else mma.sync): the CUDA kernel (bf16) for a CUDA a,
    gemm_ln_plain for a CPU a. form "post": out = T(LN(acc)), with
    film_scale/film_shift (M / L, N) T(resid + (fs+1) * LN(acc) + fb);
    "film_pre": T(LN(resid + (fs+1) * (acc + prod_bias) + fb)). next_ln as
    gemm_ln_plain's (its angles (L, N) set L)."""
    r = _ln_fold("gemm_ln_wg", a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L, next_ln)
    if a.device.type == "cuda":
        gemm_ln_wg.launches += 1
    return r


gemm_ln_wg.launches = 0


def gemm_ln(a, w, scale, bias, eps: float = 1e-5, form: str = "post", prod_bias=None, resid=None,
            film_scale=None, film_shift=None, L: int = 1, next_ln=None):
    """The LayerNorm fold on the mma.sync body alone (gemm_ln of
    csrc/gemm_mma.cuh), the body gemm_ln_wg replaces: for measurement and
    tests. Arguments as gemm_ln_wg's."""
    r = _ln_fold("gemm_ln", a, w, scale, bias, eps, form, prod_bias, resid, film_scale, film_shift, L, next_ln)
    if a.device.type == "cuda":
        gemm_ln.launches += 1
    return r


gemm_ln.launches = 0


def c_body(ns, K: int, addrs: dict, L: int = 1, ln_fold: bool = False) -> str:
    """The body the C code picks (csrc/gemm.cu tcd_wg_plan, tcd_ln_wg_plan,
    the rule of csrc/gemm_wgmma.cuh) for products of N = ns[g] over K at
    the given addresses (ints, compared with alignments only, never read):
    addrs names a0.., w0.., c0.. and bias, resid, fs, fb (the products),
    or a, w, out, out2, resid, cos, ssin, s, b, s2, b2, bias, fs, fb (a
    fold, ln_fold with one N); a name left out is null. "wgmma" or
    "mma.sync". Needs the card's build of csrc/gemm.cu."""
    lib = _build.load("gemm")
    ns = list(ns)
    if ln_fold:
        fn, args = lib.tcd_ln_wg_plan, _LnArgs(M=1, N=ns[0], K=K, L=L, **addrs)
        fn.argtypes = [ctypes.POINTER(_LnArgs)]
    else:
        fn, args = lib.tcd_wg_plan, _WgArgs(M=1, K=K, L=L, groups=len(ns), **{f"n{i}": n for i, n in enumerate(ns)},
                                            **addrs)
        fn.argtypes = [ctypes.POINTER(_WgArgs)]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(args))
    if rc < 0:
        raise ValueError(f"the C rule does not take {len(ns)} products")
    return "wgmma" if rc == 1 else "mma.sync"


def body_launches(lib: str = "gemm") -> dict:
    """{"mma.sync": n, "wgmma": n}: the launches of each product body that
    csrc/<lib>.cu (gemm, sa_block, ff_tail, ff_block, ca_block, layer,
    ln_rotary_matmul or ln_matmul) has enqueued since it was loaded,
    counted by the C code where it launches (a LayerNorm fold counts as
    one)."""
    fn = _build.load(lib).tcd_body_launches
    out = (ctypes.c_longlong * 2)()
    fn(out)
    return {"mma.sync": out[0], "wgmma": out[1]}


def tma_stats(lib: str = "gemm") -> dict:
    """{"lookups", "encodes", "us"}: the tensor maps csrc/<lib>.cu has looked
    up and encoded since it was loaded, and the host us they took."""
    out = (ctypes.c_double * 3)()
    _build.load(lib).tcd_tma_stats(out)
    return {"lookups": int(out[0]), "encodes": int(out[1]), "us": out[2]}
