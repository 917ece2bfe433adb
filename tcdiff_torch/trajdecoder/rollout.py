"""Autoregressive DBN rollout over sliding music windows.

The port of `tcdiff_tpu/trajdecoder/rollout.py:19-50` (there a lax.scan),
written as the reference's own host loop (`TCDiff.py:527-547`): seed with
`window_size` XY frames, then feed the last window and a
(window + step) * 2-frame music slice to the TrajDecoder and keep the last
`step` predicted frames, for every window start in
range(0, L + 1 - (window + step) * 2, step * 2).
"""

from __future__ import annotations

import torch

from tcdiff_torch.trajdecoder.model import TrajDecoder


def rollout_starts(cond_len: int, window_size: int, step: int) -> list:
    """The music frame where each rollout window starts."""
    return list(range(0, cond_len + 1 - (window_size + step) * 2, step * 2))


@torch.no_grad()
def autoregressive_rollout(model: TrajDecoder, seed_traj: torch.Tensor, music: torch.Tensor,
                           window_size: int = 100, step: int = 25) -> torch.Tensor:
    """seed_traj: (b, dn, window_size, 2) XY seed; music: (b, L, 438) at 2x
    motion FPS, both on the model's device. Returns
    (b, dn, window_size + n_windows * step, 2); the seed itself when the
    music holds no window."""
    music_win = (window_size + step) * 2
    window, pieces = seed_traj, [seed_traj]
    for start in rollout_starts(music.shape[1], window_size, step):
        window = model(window, music[:, start:start + music_win])
        pieces.append(window[:, :, -step:])
    return torch.cat(pieces, dim=2) if len(pieces) > 1 else seed_traj
