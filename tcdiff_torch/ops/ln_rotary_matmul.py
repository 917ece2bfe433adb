"""LayerNorm -> rotary -> projections: K8 of the port.

Counterpart of `tcdiff_tpu/ops/fused_ln_rotary_matmul.py::
fused_ln_rotary_matmul`, both of its Pallas programs:

    y = LN(x) (f32)      r = y * cos + swap_pairs(y) * ssin (f32)
    _kernel:           (T(r) . w_rot^T, T(y) . w_plain^T)
    _kernel_rot_only:  T(r) . w_rot^T                       (w_plain None)

with cos and the sign-folded sin rounded to x's dtype T first (the TPU
kernel's `_tables`, `sa_block.rotary_tables` here) and f32 sums. The
per-op serving path calls it for the self-attention q/k/v (w_rot = (w_q,
w_k), w_plain = w_v) and, with the k/v cache off, for the cross-attention
query (w_rot = w_q). w_rot is one weight, or the JAX-shaped joined [w_q;
w_k], whose rotated output is one tensor; or a tuple of weights, whose
rotated outputs are a tuple. x (b, L, d); angles (L, d) f32; weights in
nn.Linear layout (n, d), in the compute dtype. `ln_rotary_matmul` runs
the CUDA kernel (`csrc/ln_rotary_matmul.cu`) for a CUDA tensor and
`ln_rotary_matmul_plain` for a CPU tensor. In bf16 the kernel is two
launches, the row body writing y and rot(y) and every product in one
launch of the wgmma + TMA body.
"""

from __future__ import annotations

import torch

from tcdiff_torch.models.rotary import swap_pairs
from tcdiff_torch.ops._common import args_struct, as_t, check_cuda, launch, ln_f32, mm_f32, scratch
from tcdiff_torch.ops.sa_block import cached_rotary_tables, rotary_tables
from tcdiff_torch.utils.profiling import traced


def _weights(w_rot):
    """(the rotated weights as a list, whether they were given apart)."""
    apart = isinstance(w_rot, (list, tuple))
    return (list(w_rot) if apart else [w_rot]), apart


def ln_rotary_matmul_plain(x, scale, bias, angles, w_rot, w_plain=None, eps: float = 1e-5):
    """Plain PyTorch version of the kernel; its oracle."""
    dt = x.dtype
    ws, apart = _weights(w_rot)
    cos, ssin = rotary_tables(angles, dt)
    y = ln_f32(x, scale, bias, eps)
    r = (y * cos.float() + swap_pairs(y) * ssin.float()).to(dt)
    rot = [mm_f32(r, w).to(dt) for w in ws]
    rot = tuple(rot) if apart else rot[0]
    if w_plain is None:
        return rot
    return rot, mm_f32(y.to(dt), w_plain).to(dt)


_Args = args_struct(  # LnRotArgs in csrc/ln_rotary_matmul.cu
    "LnRotArgs",
    ("x", "s", "b", "cos", "ssin", "wr0", "wr1", "wp", "y", "r", "o0", "o1", "ov"),
    ("M", "L", "d", "n0", "n1", "np"),
    ("eps",),
)


def _ln_rotary_matmul_cuda(x, scale, bias, angles, w_rot, w_plain, eps):
    ws, apart = _weights(w_rot)
    if not 1 <= len(ws) <= 2:
        raise ValueError(f"give one rotated weight or two apart, got {len(ws)}")
    check_cuda(x, scale=scale, bias=bias, angles=angles, w_plain=w_plain, **{f"w_rot{i}": w for i, w in enumerate(ws)})
    B, L, d = x.shape
    if d % 2:
        raise ValueError(f"d={d} must be even")
    shapes = [("scale", scale, (d,)), ("bias", bias, (d,)), ("angles", angles, (L, d))]
    shapes += [(f"w_rot[{i}]", w, (w.shape[0], d)) for i, w in enumerate(ws)]
    if w_plain is not None:
        shapes.append(("w_plain", w_plain, (w_plain.shape[0], d)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")

    # host work only: the tables once per angle table, no cast of what is
    # already in its dtype, the outputs and the scratch from one allocation
    dt = x.dtype
    cos, ssin = cached_rotary_tables(angles, dt)
    s, b = as_t(scale, torch.float32), as_t(bias, torch.float32)
    wr = [as_t(w, dt) for w in ws]
    wp = None if w_plain is None else as_t(w_plain, dt)
    rows = lambda n: ((B, L, n), dt)
    ten = scratch(x.device, dict(y=None if wp is None else rows(d), r=rows(d),
                                 o0=rows(wr[0].shape[0]), o1=rows(wr[1].shape[0]) if apart else None,
                                 ov=None if wp is None else rows(wp.shape[0])))
    ten.update(x=x, s=s, b=b, cos=cos, ssin=ssin, wr0=wr[0], wr1=wr[1] if apart else None, wp=wp)
    dims = dict(M=B * L, L=L, d=d, n0=wr[0].shape[0], n1=wr[1].shape[0] if apart else 0,
                np=0 if wp is None else wp.shape[0], eps=eps)
    launch("ln_rotary_matmul", "tcd_ln_rotary_matmul", _Args, {k: t for k, t in ten.items() if t is not None},
           dims, x, "ln_rotary_matmul")
    ln_rotary_matmul.launches += 1
    rot = (ten["o0"], ten["o1"]) if apart else ten["o0"]
    return rot if wp is None else (rot, ten["ov"])


@traced("k8.ln_rotary_matmul")
def ln_rotary_matmul(x, scale, bias, angles, w_rot, w_plain=None, eps: float = 1e-5):
    """LN -> rotary -> projection(s): CUDA kernel for a CUDA x, plain
    version for a CPU x. Returns (rotated, v), or the rotated output(s)
    alone without w_plain; the rotated output is a tuple where w_rot is."""
    if x.device.type == "cpu":
        return ln_rotary_matmul_plain(x, scale, bias, angles, w_rot, w_plain, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_rotary_matmul runs on CPU or CUDA tensors, got {x.device}")
    return _ln_rotary_matmul_cuda(x, scale, bias, angles, w_rot, w_plain, eps)


ln_rotary_matmul.launches = 0  # kernel launches; the plain path does not count
