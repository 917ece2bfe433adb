"""Rotation conversions and SMPL forward kinematics, for the train loss,
the dataset, the sample post-processing and the eval metrics."""

from tcdiff_torch.geometry.rotations import (  # noqa: F401
    ax_from_6v,
    ax_to_6v,
    axis_angle_to_matrix,
    axis_angle_to_quaternion,
    matrix_to_axis_angle,
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    quat_apply,
    quat_from_6v,
    quat_multiply,
    quat_slerp,
    quat_to_6v,
    quaternion_to_axis_angle,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)
from tcdiff_torch.geometry.skeleton import (  # noqa: F401
    SMPL_JOINTS,
    SMPL_OFFSETS,
    SMPL_PARENTS,
    smpl_fk,
    smpl_fk_from_6d,
)
