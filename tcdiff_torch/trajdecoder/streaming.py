"""Incremental DBN trajectory for streaming serving.

The port of `tcdiff_tpu/trajdecoder/streaming.py:31-97`. `generate` rolls
the whole song's trajectory before any motion is denoised (the reference's
`TCDiff.py:527-550`); for streaming that puts the whole rollout and Kalman
pass in front of the first slice. `TrajectoryStreamer` rolls and filters
only as far as the next slice needs, carrying the DBN window and the Kalman
state. Both stages are causal, so the frames are exactly those of the full
rollout and the batch filter (tests/test_torch_trajdecoder.py).
"""

from __future__ import annotations

import torch

from tcdiff_torch.trajdecoder.kalman import kalman_filter_chunk
from tcdiff_torch.trajdecoder.model import TrajDecoder


class TrajectoryStreamer:
    """Smoothed trajectory frames on demand.

    seed: (b, dn, window_size, 2) normalized XY; music: (b, L, 438) at 2x
    motion FPS; both go to the model's device. `frames(upto)` returns the
    first `upto` smoothed frames (b, dn, upto, 2); once the music runs out
    the last frame is held (as `generate` pads its tail).
    """

    def __init__(self, model: TrajDecoder, seed, music, window_size: int = 100, step: int = 25):
        dev = model.device
        self.model = model
        self.music = torch.as_tensor(music, dtype=torch.float32, device=dev)
        self.window_size, self.step = window_size, step
        self.window = torch.as_tensor(seed, dtype=torch.float32, device=dev)  # current DBN window
        self._b, self._dn = self.window.shape[:2]
        self.raw = [self.window]  # unfiltered chunks, the seed first
        self.raw_len = window_size
        self.next_start = 0  # the next window's first music frame
        self.smoothed = None  # filtered frames so far
        self.kstate = None

    def _can_roll(self) -> bool:
        return self.next_start + (self.window_size + self.step) * 2 <= self.music.shape[1]

    def _roll_once(self) -> None:
        """One DBN window, as one step of `autoregressive_rollout`."""
        music_win = (self.window_size + self.step) * 2
        self.window = self.model(self.window, self.music[:, self.next_start:self.next_start + music_win])
        self.raw.append(self.window[:, :, -self.step:])
        self.raw_len += self.step
        self.next_start += self.step * 2

    def frames(self, upto: int) -> torch.Tensor:
        """Smoothed trajectory (b, dn, upto, 2); rolls and filters lazily."""
        while self.raw_len < upto and self._can_roll():
            self._roll_once()
        if self.raw:  # filter what was rolled since the last call
            chunk = torch.cat(self.raw, dim=2)
            self.raw = []
            out, self.kstate = kalman_filter_chunk(chunk.reshape(self._b * self._dn, -1, 2), self.kstate)
            out = out.reshape(self._b, self._dn, -1, 2)
            self.smoothed = out if self.smoothed is None else torch.cat([self.smoothed, out], dim=2)
        traj = self.smoothed
        if traj.shape[2] < upto:  # the music ran out: hold the last frame
            return torch.cat([traj, traj[:, :, -1:].expand(-1, -1, upto - traj.shape[2], -1)], dim=2)
        return traj[:, :, :upto]
