"""Rotation conversions: what the FK loss needs (6D -> matrix ->
quaternion, quaternion products), what the dataset needs (axis-angle
<-> quaternion, quaternion -> matrix -> 6D), and what the sample
post-processing and export need (6D -> axis-angle, matrix -> axis-angle,
quaternion <-> 6D, slerp).

PyTorch counterpart of the matching functions of
`tcdiff_tpu/geometry/rotations.py`. Quaternions are real-first (w, x, y,
z). Every function broadcasts over leading dimensions and is
differentiable with finite gradients: the square roots and norms use a
double `where`, so that the branch not taken never feeds an infinite
derivative into the product with zero; the axis-angle conversions take a
Taylor branch below 1e-6 rad.
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


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) wxyz quaternion: [cos(a/2),
    sin(a/2)/a * axis_angle], a = |axis_angle|; sin(a/2)/a is 0.5 - a^2/48
    below 1e-6 rad."""
    angles = _safe_norm(axis_angle)
    half = angles * 0.5
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48.0, torch.sin(half) / safe)
    return torch.cat([torch.cos(half), axis_angle * sin_half_over], dim=-1)


def quaternion_to_axis_angle(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3) axis-angle.

    The half angle's atan2 is taken in float64 and rounded: PyTorch's CPU
    atan2 in float32 gives other bits in its vectorised loop than in the
    loop's scalar tail, so a float32 result would depend on how a batch is
    split into calls (the dataset processes in chunks)."""
    norms = _safe_norm(quaternion[..., 1:])
    half = torch.atan2(norms.double(), quaternion[..., :1].double()).to(quaternion.dtype)
    angles = 2.0 * half
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over = torch.where(small, 0.5 - angles * angles / 48.0, torch.sin(half) / safe)
    return quaternion[..., 1:] / sin_half_over


def quaternion_to_matrix(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = quaternion.unbind(-1)
    two_s = 2.0 / (quaternion * quaternion).sum(-1)
    m = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quaternion.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def ax_to_6v(ax: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> 6D (the reference's `dataset/quaternion.py` name)."""
    return matrix_to_rotation_6d(axis_angle_to_matrix(ax))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def quat_slerp(x: torch.Tensor, y: torch.Tensor, a) -> torch.Tensor:
    """Spherical linear interpolation of wxyz quaternions x, y (..., 4) by
    weights `a` (a number or a tensor broadcastable to x's leading dims):
    y flipped where the two lie more than 90 degrees apart (the shorter
    arc), a linear blend where 1 - cos(omega) < 0.01 (the reference's
    `dataset/quaternion.py:35-71`, without its in-place flip of y)."""
    cos_omega = (x * y).sum(-1)
    neg = cos_omega < 0.0
    cos_omega = torch.where(neg, -cos_omega, cos_omega)
    y = torch.where(neg[..., None], -y, y)
    a = torch.zeros_like(x[..., 0]) + a
    linear = (1.0 - cos_omega) < 0.01
    # the acos and the division guarded on the linear branch
    omega = torch.arccos(torch.where(linear, torch.zeros_like(cos_omega), cos_omega).clamp(-1.0, 1.0))
    safe_sin = torch.where(linear, torch.ones_like(omega), torch.sin(omega))
    amount0 = torch.where(linear, 1.0 - a, torch.sin((1.0 - a) * omega) / safe_sin)
    amount1 = torch.where(linear, a, torch.sin(a * omega) / safe_sin)
    return amount0[..., None] * x + amount1[..., None] * y


def quat_to_6v(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(quaternion_to_matrix(q))


def quat_from_6v(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_quaternion(rotation_6d_to_matrix(d6))


def ax_from_6v(d6: torch.Tensor) -> torch.Tensor:
    """6D -> axis-angle (the reference's `dataset/quaternion.py` name)."""
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))
