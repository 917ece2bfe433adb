"""Synthetic AIOZ-like data for tests, measurements and dataset-free runs.

The port of `tcdiff_tpu/data/synthetic.py`, with the same numpy draws, so
one seed gives the same raw arrays in both packages: smooth random
multi-dancer motion (slowly varying joint rotations, wandering roots) and
music-feature stand-ins, in the real pipeline's shapes (motion (dn, 150,
151 packed channels), music (301, 438) at 60 FPS). The packing and the
normalization go through the dataset's own `_process_batch`.
"""

from __future__ import annotations

import numpy as np
import torch

from tcdiff_torch.config import N_JOINTS
from tcdiff_torch.data.dataset import _per_sample_normalize, _process_batch
from tcdiff_torch.data.normalizer import Normalizer


def _smooth_noise(rng, shape, smoothing=15):
    """Low-pass filtered gaussian noise along axis -2 (time)."""
    from scipy.ndimage import uniform_filter1d

    x = rng.normal(size=shape)
    # a box filter along time, which keeps the length even when the window
    # exceeds the sequence
    return uniform_filter1d(x, size=smoothing, axis=-2 if x.ndim > 1 else 0, mode="nearest")


def synthetic_motion(n: int, dancer_num: int = 3, seq_len: int = 150, seed: int = 0):
    """Raw (pos (n, dn, S, 3), q (n, dn, S, 72)) pairs shaped like the
    sliced AIOZ pkls, Y-up."""
    rng = np.random.default_rng(seed)
    # wandering roots: integrated small velocities, dancers offset on a circle
    vel = _smooth_noise(rng, (n, dancer_num, seq_len, 3)) * 0.02
    pos = np.cumsum(vel, axis=2)
    angles = 2 * np.pi * np.arange(dancer_num) / max(dancer_num, 1)
    offsets = np.stack([np.cos(angles), np.zeros_like(angles), np.sin(angles)], -1)
    pos = pos + offsets[None, :, None, :] * 1.5
    pos[..., 1] += 0.9  # roughly hip height in Y-up

    # smooth joint axis-angle rotations, small magnitudes
    q = _smooth_noise(rng, (n, dancer_num, seq_len, 72)) * 0.4
    return pos.astype(np.float32), q.astype(np.float32)


def synthetic_music(n: int, frames: int = 301, dim: int = 438, seed: int = 1):
    rng = np.random.default_rng(seed)
    feats = _smooth_noise(rng, (n, frames, dim), smoothing=5).astype(np.float32)
    # beat-like impulses in one channel, mimicking the one-hot beat feature
    feats[:, ::30, 53] = 1.0
    return feats


def synthetic_dataset(n: int = 8, dancer_num: int = 3, seq_len: int = 150, seed: int = 0,
                      per_sample_normalization: bool = True, device="cuda"):
    """Processed, normalized dataset arrays: (poses (n, dn, S, 151) numpy,
    music (n, 2S+1, 438) numpy, normalizer on `device`)."""
    pos, q = synthetic_motion(n, dancer_num, seq_len, seed)
    packed = _process_batch(torch.from_numpy(pos).to(device),
                            torch.from_numpy(q.reshape(n, dancer_num, seq_len, N_JOINTS, 3)).to(device))
    if per_sample_normalization:
        normalized, normalizer = _per_sample_normalize(packed)
    else:
        normalizer = Normalizer.fit(packed, device=packed.device)
        normalized = normalizer.normalize(packed)
    music = synthetic_music(n, 2 * seq_len + 1, seed=seed + 1)
    return normalized.cpu().numpy(), music, normalizer


def synthetic_batch(batch_size: int = 2, dancer_num: int = 3, seq_len: int = 150, seed: int = 0, device="cuda"):
    """One training batch on `device`: x (B, dn, S, 151), cond (B, 2S+1,
    438), and the normalizer."""
    poses, music, normalizer = synthetic_dataset(batch_size, dancer_num, seq_len, seed, device=device)
    return torch.from_numpy(poses).to(device), torch.from_numpy(music).to(device), normalizer
