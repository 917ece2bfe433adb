"""Int8 projections for serving (TCDIFF_INT8).

Counterpart of `tcdiff_tpu/ops/int8.py`, with its exact semantics:

  * weights: symmetric int8 per output channel, scale = max(amax, 1e-8) /
    127, quantized from the f32 parameters;
  * activations: symmetric int8 per token, quantized on every call;
  * codes: round half to even, clipped to +-127;
  * the product in int32, dequantized as acc * (sx (x) sw) in f32, plus the
    bias, cast to x's dtype.

The JAX package computes the int8 x int8 -> int32 product as an XLA
dot_general outside any Pallas kernel; here it is `torch._int_mm` for
CUDA tensors (M > 16, K and N multiples of 8: every serving shape) and an
int32 matmul, the plain version, for CPU tensors. Weights are in
nn.Linear layout (out, in). `quantized_weight` quantizes a parameter once
and keeps the result on it until the parameter changes in place (the JAX
package gets the same from XLA hoisting the loop-invariant quantization).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _per_127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 by a true division on every device (PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, an ulp
    off at times)."""
    return torch.clamp_min(amax, 1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per output channel: w (out, in) -> (int8 (out, in), f32 scale (out,))."""
    w = w.float()
    scale = _per_127(w.abs().amax(dim=1))
    return torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8), scale


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per token: x (..., in) -> (int8 (..., in), f32 scale (...,))."""
    xf = x.float()
    scale = _per_127(xf.abs().amax(dim=-1))
    return torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8), scale


def quantized_weight(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_weight` of the parameter p, kept on p and made again only
    after p changes in place (its version counter moves)."""
    kept = getattr(p, "_int8_codes", None)
    if kept is None or kept[0] != p._version:
        with torch.no_grad():
            kept = (p._version, *quantize_weight(p.detach()))
        p._int8_codes = kept
    return kept[1], kept[2]


def int_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) . wq (N, K)^T in int32: the plain version of the product."""
    return torch.matmul(xq.to(torch.int32), wq.to(torch.int32).t())


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) . wq (N, K)^T, int8 codes to int32 sums: `torch._int_mm`
    for CUDA tensors (counted in `int_mm.launches`), the plain version for
    CPU tensors."""
    if xq.device.type == "cpu":
        return int_mm_plain(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"int_mm runs on CPU or CUDA tensors, got {xq.device}")
    acc = torch._int_mm(xq, wq.t())
    int_mm.launches += 1
    return acc


int_mm.launches = 0


def int8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """y = x . W^T (+ bias) through int8 codes: x (..., in) in any float
    dtype; (wq, sw) the weight's codes and scales (`quantize_weight`);
    bias (out,) or None. Returns x's dtype."""
    xq, sx = quantize_act(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], -1)
    y = acc.float() * (sx[..., None] * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
