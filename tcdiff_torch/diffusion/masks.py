"""Channel and frame masks for inpainting-style sampling.

PyTorch copy of `tcdiff_tpu/diffusion/masks.py`: float32 masks of a
(..., seq, channels) shape, 1 where the input is KEPT and 0 where the model
fills in; they plug into `GaussianDiffusion.p_sample_loop(mode="inpaint",
constraint={"mask": ..., "value": ...})`. Made on `device` (the GPU unless
the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Sequence

import torch

LOWERBODY_JOINTS = (0, 1, 2, 4, 5, 7, 8, 10, 11)
UPPERBODY_JOINTS = (0, 3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)


def joint_indices_to_channel_indices(indices: Sequence[int]) -> list:
    """Joint ids -> rot6d channel ids of the 151-d layout
    [contacts(4), root(3), rot6d(24*6)]: joint j spans 7+6j .. 7+6j+6."""
    out = []
    for j in indices:
        out += list(range(7 + 6 * j, 7 + 6 * j + 6))
    return out


def first_last_mask(shape, start_width: int = 1, end_width: int = 1, device="cuda") -> torch.Tensor:
    mask = torch.zeros(shape, device=device)
    mask[..., :start_width, :] = 1.0
    mask[..., -end_width:, :] = 1.0
    return mask


def first_mask(shape, start_width: int = 1, device="cuda") -> torch.Tensor:
    mask = torch.zeros(shape, device=device)
    mask[..., :start_width, :] = 1.0
    return mask


def middle_mask(shape, start: int = 0, end: int = -1, device="cuda") -> torch.Tensor:
    mask = torch.zeros(shape, device=device)
    mask[..., start:end, :] = 1.0
    return mask


def _body_mask(shape, joints: Sequence[int], include_root: bool, device) -> torch.Tensor:
    chans = joint_indices_to_channel_indices(joints)
    if include_root:
        chans = chans + [4, 5, 6]  # root position channels
    mask = torch.zeros(shape, device=device)
    mask[..., :, chans] = 1.0
    return mask


def lowerbody_mask(shape, device="cuda") -> torch.Tensor:
    """Keep the legs and the root trajectory."""
    return _body_mask(shape, LOWERBODY_JOINTS, True, device)


def upperbody_mask(shape, device="cuda") -> torch.Tensor:
    """Keep the torso, the arms and the root trajectory."""
    return _body_mask(shape, UPPERBODY_JOINTS, True, device)
