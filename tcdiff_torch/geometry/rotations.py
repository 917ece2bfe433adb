"""Rotation conversions the FK loss needs: 6D -> matrix -> quaternion, and
quaternion products.

PyTorch counterpart of the matching functions of
`tcdiff_tpu/geometry/rotations.py`. Quaternions are real-first (w, x, y,
z). Every function broadcasts over leading dimensions and is
differentiable with finite gradients: the square roots and norms use a
double `where`, so that the branch not taken never feeds an infinite
derivative into the product with zero.
"""

from __future__ import annotations

import torch


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient where x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis (kept) with a zero gradient at x == 0."""
    sq = (x * x).sum(-1, keepdim=True)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4):
    v + 2 w (qv x v) + qv x (2 qv x v)."""
    w, qv = q[..., :1], q[..., 1:]
    t = torch.linalg.cross(qv, v, dim=-1) * 2.0
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion: the four
    candidates of the classic algorithm, the one with the largest
    discriminant selected by a one-hot contraction."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    # each candidate divided by 2 * q_abs of its branch; the 0.1 floor only
    # ever applies to candidates that are not selected
    cands = cands / (2.0 * q_abs.clamp_min(0.1))[..., None]
    one_hot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(matrix.dtype)
    out = (cands * one_hot[..., None]).sum(-2)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt on the two encoded rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _safe_norm(a1).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / _safe_norm(b2).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)
