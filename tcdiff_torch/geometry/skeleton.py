"""SMPL 24-joint skeleton and level-parallel forward kinematics.

PyTorch counterpart of the default FK of `tcdiff_tpu/geometry/skeleton.py`
(from 6D rotations for the loss, from axis-angle for the dataset):
the kinematic chain is walked by tree depth, all joints of one level (whose
parents are independent) in one batched quaternion step, 8 levels in all.
Same parents, rest offsets and quaternion math.
"""

from __future__ import annotations

import numpy as np
import torch

from tcdiff_torch.config import N_JOINTS
from tcdiff_torch.geometry.rotations import (
    axis_angle_to_quaternion, matrix_to_quaternion, quat_apply, quat_multiply, rotation_6d_to_matrix,
)

# joint names (the reference's `vis.py:20-45`)
SMPL_JOINTS = [
    "root", "lhip", "rhip", "belly", "lknee", "rknee", "spine", "lankle",
    "rankle", "chest", "ltoes", "rtoes", "neck", "linshoulder", "rinshoulder",
    "head", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist", "rwrist",
    "lhand", "rhand",
]

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

SMPL_OFFSETS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.05858135, -0.08228004, -0.01766408],
        [-0.06030973, -0.09051332, -0.01354254],
        [0.00443945, 0.12440352, -0.03838522],
        [0.04345142, -0.38646945, 0.008037],
        [-0.04325663, -0.38368791, -0.00484304],
        [0.00448844, 0.1379564, 0.02682033],
        [-0.01479032, -0.42687458, -0.037428],
        [0.01905555, -0.4200455, -0.03456167],
        [-0.00226458, 0.05603239, 0.00285505],
        [0.04105436, -0.06028581, 0.12204243],
        [-0.03483987, -0.06210566, 0.13032329],
        [-0.0133902, 0.21163553, -0.03346758],
        [0.07170245, 0.11399969, -0.01889817],
        [-0.08295366, 0.11247234, -0.02370739],
        [0.01011321, 0.08893734, 0.05040987],
        [0.12292141, 0.04520509, -0.019046],
        [-0.11322832, 0.04685326, -0.00847207],
        [0.2553319, -0.01564902, -0.02294649],
        [-0.26012748, -0.01436928, -0.03126873],
        [0.26570925, 0.01269811, -0.00737473],
        [-0.26910836, 0.00679372, -0.00602676],
        [0.08669055, -0.01063603, -0.01559429],
        [-0.0887537, -0.00865157, -0.01010708],
    ],
    dtype=np.float32,
)


def _levels(parents: np.ndarray):
    """Joint indices grouped by tree depth (the root, depth 0, excluded)."""
    depth = np.zeros(len(parents), dtype=np.int64)
    for j, p in enumerate(parents):
        if p >= 0:
            depth[j] = depth[p] + 1
    return [np.nonzero(depth == d)[0].tolist() for d in range(1, int(depth.max()) + 1)]


LEVELS = _levels(SMPL_PARENTS)  # 8 levels of non-root joints


def fk_from_quats(quats: torch.Tensor, root_positions: torch.Tensor) -> torch.Tensor:
    """World joint positions (..., 24, 3) from local rotations (..., 24, 4)
    and root positions (..., 3)."""
    offsets = torch.as_tensor(SMPL_OFFSETS, dtype=root_positions.dtype, device=root_positions.device)
    rot_w = [None] * N_JOINTS
    pos_w = [None] * N_JOINTS
    rot_w[0], pos_w[0] = quats[..., 0, :], root_positions
    for level in LEVELS:
        parent_rot = torch.stack([rot_w[SMPL_PARENTS[j]] for j in level], dim=-2)
        parent_pos = torch.stack([pos_w[SMPL_PARENTS[j]] for j in level], dim=-2)
        world_pos = quat_apply(parent_rot, offsets[level].expand(parent_rot.shape[:-1] + (3,))) + parent_pos
        world_rot = quat_multiply(parent_rot, quats[..., level, :])
        for k, j in enumerate(level):
            pos_w[j], rot_w[j] = world_pos[..., k, :], world_rot[..., k, :]
    return torch.stack(pos_w, dim=-2)


def smpl_fk(rotations: torch.Tensor, root_positions: torch.Tensor) -> torch.Tensor:
    """FK from local axis-angle rotations (..., 24, 3) and root positions
    (..., 3): world joint positions (..., 24, 3), the layout of the
    reference's `SMPLSkeleton.forward` (`vis.py:358-406`)."""
    return fk_from_quats(axis_angle_to_quaternion(rotations), root_positions)


def smpl_fk_from_6d(rot6d: torch.Tensor, root_positions: torch.Tensor) -> torch.Tensor:
    """FK from 6D rotations (..., 24, 6): 6D -> matrix -> quaternion -> chain."""
    return fk_from_quats(matrix_to_quaternion(rotation_6d_to_matrix(rot6d)), root_positions)
