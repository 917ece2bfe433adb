"""BVH export of SMPL motion — a dependency-free Blender import path.

A copy of `tcdiff_tpu/export/bvh.py`, which writes the same file byte for
byte. The reference converts pkl -> FBX with the proprietary Autodesk FBX
SDK (`Blender_Visulization/2-ConvertPkl2FBX_SMPL.py`,
`src/FbxReadWriter.py:19-147`), which is not a public package. BVH carries
the same animation payload (skeleton hierarchy + per-frame root translation
and joint rotations) in a plain-text format Blender/Maya import natively,
so the Blender retarget step of the pipeline keeps working without the SDK.
The FBX path is still available when the SDK exists (see fbx_export.py).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np

from tcdiff_torch.geometry.skeleton import SMPL_JOINTS, SMPL_OFFSETS, SMPL_PARENTS


def _children(parents: Sequence[int]) -> List[List[int]]:
    ch: List[List[int]] = [[] for _ in parents]
    for j, p in enumerate(parents):
        if p >= 0:
            ch[p].append(j)
    return ch


def _axis_angle_to_euler_zxy_deg(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> intrinsic ZXY euler angles in degrees (the BVH
    channel order written below)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-8
    axis = np.where(theta > 1e-8, aa / np.maximum(theta, 1e-8), 0.0)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = np.cos(theta[..., 0])
    s = np.sin(theta[..., 0])
    C = 1 - c
    # rotation matrix from axis-angle (Rodrigues)
    R = np.empty(aa.shape[:-1] + (3, 3))
    R[..., 0, 0] = x * x * C + c
    R[..., 0, 1] = x * y * C - z * s
    R[..., 0, 2] = x * z * C + y * s
    R[..., 1, 0] = y * x * C + z * s
    R[..., 1, 1] = y * y * C + c
    R[..., 1, 2] = y * z * C - x * s
    R[..., 2, 0] = z * x * C - y * s
    R[..., 2, 1] = z * y * C + x * s
    R[..., 2, 2] = z * z * C + c
    # R = Rz @ Rx @ Ry  (ZXY intrinsic): solve for angles
    sx = np.clip(R[..., 2, 1], -1.0, 1.0)
    rx = np.arcsin(sx)
    cx = np.cos(rx)
    safe = np.abs(cx) > 1e-6
    ry = np.where(safe, np.arctan2(-R[..., 2, 0], R[..., 2, 2]), 0.0)
    rz = np.where(
        safe, np.arctan2(-R[..., 0, 1], R[..., 1, 1]),
        np.arctan2(R[..., 1, 0], R[..., 0, 0]),
    )
    out = np.degrees(np.stack([rz, rx, ry], axis=-1))
    out[small] = 0.0
    return out


def write_bvh(
    path: str,
    poses: np.ndarray,
    trans: np.ndarray,
    fps: int = 30,
    scale: float = 100.0,
    joint_names: Sequence[str] = tuple(SMPL_JOINTS),
) -> str:
    """poses: (T, 72) axis-angle; trans: (T, 3) root positions (meters).

    `scale` converts to BVH's conventional centimeters.
    """
    poses = np.asarray(poses, dtype=np.float64).reshape(-1, 24, 3)
    trans = np.asarray(trans, dtype=np.float64)
    T = poses.shape[0]
    offsets = np.asarray(SMPL_OFFSETS, dtype=np.float64) * scale
    children = _children(SMPL_PARENTS)

    lines: List[str] = ["HIERARCHY"]

    def emit(j: int, indent: int, is_root: bool):
        pad = "  " * indent
        tag = "ROOT" if is_root else "JOINT"
        lines.append(f"{pad}{tag} {joint_names[j]}")
        lines.append(pad + "{")
        off = offsets[j]
        lines.append(f"{pad}  OFFSET {off[0]:.6f} {off[1]:.6f} {off[2]:.6f}")
        if is_root:
            lines.append(
                f"{pad}  CHANNELS 6 Xposition Yposition Zposition "
                "Zrotation Xrotation Yrotation"
            )
        else:
            lines.append(f"{pad}  CHANNELS 3 Zrotation Xrotation Yrotation")
        if children[j]:
            for c in children[j]:
                emit(c, indent + 1, False)
        else:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.0 0.0 0.0")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    emit(0, 0, True)
    lines.append("MOTION")
    lines.append(f"Frames: {T}")
    lines.append(f"Frame Time: {1.0 / fps:.8f}")

    euler = _axis_angle_to_euler_zxy_deg(poses)  # (T, 24, 3) ZXY degrees
    order = _traversal_order()
    for t in range(T):
        row = [f"{v:.6f}" for v in (trans[t] * scale)]
        for j in order:
            row += [f"{v:.4f}" for v in euler[t, j]]
        lines.append(" ".join(row))

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _traversal_order() -> List[int]:
    """Depth-first joint order matching the HIERARCHY emission above."""
    children = _children(SMPL_PARENTS)
    order: List[int] = []

    def walk(j: int):
        order.append(j)
        for c in children[j]:
            walk(c)

    walk(0)
    return order


def pkl_to_bvh(pkl_path: str, out_dir: str, fps: int = 30) -> str:
    """Convert a per-dancer pkl (from split_pkl) to BVH."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(pkl_path))[0]
    out = os.path.join(out_dir, stem + ".bvh")
    return write_bvh(out, data["smpl_poses"], data["smpl_trans"], fps=fps)
