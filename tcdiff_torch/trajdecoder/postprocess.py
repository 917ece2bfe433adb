"""Trajectory post-processing beyond the Kalman filter.

The port of `tcdiff_tpu/trajdecoder/postprocess.py:17-67`, the reference's
`TrajDecoder/utils/utils_model.py:76-180`: Savitzky-Golay smoothing (scipy,
on the host, along time for every trajectory at once), the offset integral
as a cumsum, the velocity clamp and hold, the confidence interval of a
metric log and the root velocity added onto translation-free motion.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import savgol_filter


def smooth_data(traj, window_length: int = 21, polyorder: int = 3):
    """Savitzky-Golay smoothing along time of (b, dn, S, C)
    (`utils_model.py:77-84`). A tensor comes back as a tensor on its device,
    an array as an array."""
    arr = traj.detach().cpu().numpy() if torch.is_tensor(traj) else np.asarray(traj)
    wl = min(window_length, arr.shape[2] if arr.shape[2] % 2 == 1 else arr.shape[2] - 1)
    out = savgol_filter(arr, wl, min(polyorder, wl - 1), axis=2)
    return torch.from_numpy(np.ascontiguousarray(out)).to(traj.device) if torch.is_tensor(traj) else out


def offset2xyz(offset: torch.Tensor, start_xyz: torch.Tensor) -> torch.Tensor:
    """Per-frame offsets (b, dn, S-1, C) from start_xyz (b, dn, 1, C) ->
    absolute positions (b, dn, S, C); the reference's quadratic cat-loop
    (`utils_model.py:86-100`) as a cumsum."""
    return torch.cat([start_xyz, start_xyz + torch.cumsum(offset, dim=2)], dim=2)


def process_traj(traj: torch.Tensor, v_max: float = 0.01, var_frame: int = 15) -> torch.Tensor:
    """Velocity clamp and piecewise-constant velocity hold
    (`utils_model.py:102-120`): per-frame offsets clipped to |v| <= v_max,
    each held at the first value of its var_frame-frame block, re-integrated."""
    offset = (traj[:, :, 1:] - traj[:, :, :-1]).clamp(-v_max, v_max)
    block_start = (torch.arange(offset.shape[2], device=traj.device) // var_frame) * var_frame
    return offset2xyz(offset[:, :, block_start], traj[:, :, 0:1])


def get_ci(acc_log):
    """(mean, 95% confidence interval) of a metric log (`utils_model.py:125-131`)."""
    arr = np.asarray(acc_log, dtype=np.float64)
    return float(arr.mean()), float(1.96 * arr.std() / np.sqrt(len(arr)))


def get_motion_with_trans(motion: torch.Tensor, velocity: torch.Tensor) -> torch.Tensor:
    """Integrated root velocity (b, T, 3), relative to its first frame,
    added onto translation-free motion (b, T, C), tiled over its C / 3 XYZ
    columns (`utils_model.py:171-180`)."""
    trans = torch.cumsum(velocity, dim=1)
    trans = trans - trans[:, :1]
    return motion + trans.repeat(1, 1, motion.shape[-1] // velocity.shape[-1])
