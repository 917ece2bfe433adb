"""Trajectory datasets for DBN training: root positions only.

The port of `tcdiff_tpu/trajdecoder/dataset.py`, which rebuilds the
reference's `TrajDecoder/dataset/traj_dataset.py:24-295`: the main
dataset's sliced-motion loading, keeping only each dancer's 3-d root
position, Y-up -> Z-up rotated and min-max normalized. The reference's
per-sample refit quirk (`traj_dataset.py:169-176`: each train sample
normalized by its own min/max, the last sample's stats the dataset's
normalizer) is kept by default, computed as one vectorised min/max a
sample on `device`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tcdiff_torch.data.dataset import _load_slices, _per_sample_normalize, rotate_points_x90
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.parallel.mesh import Rows


def _normalize_roots(roots: torch.Tensor, normalizer: Optional[Normalizer], per_sample: bool):
    """(N, dn, S, 3) Z-up roots -> (normalized roots as numpy, normalizer)."""
    if normalizer is not None:
        return normalizer.normalize(roots).cpu().numpy(), normalizer
    if per_sample:
        normalized, normalizer = _per_sample_normalize(roots)
    else:
        normalizer = Normalizer.fit(roots, device=roots.device)
        normalized = normalizer.normalize(roots)
    return normalized.cpu().numpy(), normalizer


def _batches(ds, batch_size: int, rng: Optional[np.random.Generator], drop_last: bool, cond,
             rows: Optional[Rows] = None):
    """Shuffled epoch batches; with `rows` (a data-parallel rank's share of
    each global batch) only those rows are read."""
    order = np.arange(len(ds))
    if rng is not None:
        rng.shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        if rows is not None:
            idx = rows.take(idx)
        yield {
            "x": ds.roots[idx],
            "cond": cond(idx),
            "filename": [ds.feature_files[j] for j in idx],
            "wav": [ds.wav_files[j] for j in idx],
        }


class TrajDataset:
    """Yields dict batches: x (B, dn, S, 3) normalized roots, cond (B, 2S+1,
    438), filename and wav lists. The train split fits its normalizer
    unless one is given; the test split needs the train split's."""

    def __init__(self, data_path: str, train: bool, required_dancer_num: int = 3,
                 split_file: Optional[Sequence[str]] = None, normalizer: Optional[Normalizer] = None,
                 per_sample_normalization: bool = True, cache_features: bool = True, device="cuda"):
        self.train = train
        self._feature_cache = {} if cache_features else None
        if not train and normalizer is None:
            raise ValueError("the test split needs the train split's normalizer")
        arrays, self.feature_files, self.wav_files = _load_slices(
            data_path, train, required_dancer_num, split_file, ("pos",))
        roots = rotate_points_x90(torch.from_numpy(np.stack(arrays["pos"])).to(device))  # (N, dn, S, 3)
        self.roots, self.normalizer = _normalize_roots(roots, normalizer, per_sample_normalization)

    def __len__(self):
        return len(self.roots)

    def _load_feature(self, path: str) -> np.ndarray:
        if self._feature_cache is not None and path in self._feature_cache:
            return self._feature_cache[path]
        feat = np.load(path).astype(np.float32)
        if self._feature_cache is not None:
            self._feature_cache[path] = feat
        return feat

    def get(self, idx: int):
        return self.roots[idx], self._load_feature(self.feature_files[idx]), self.feature_files[idx], \
            self.wav_files[idx]

    def batches(self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = True,
                rows: Optional[Rows] = None):
        return _batches(self, batch_size, rng, drop_last,
                        lambda idx: np.stack([self._load_feature(self.feature_files[j]) for j in idx]), rows)


class SyntheticTrajDataset:
    """A dataset-free stand-in with the same shapes, from
    `data.synthetic`'s seeded draws."""

    def __init__(self, n: int, dancer_num: int = 3, seq_len: int = 150, seed: int = 0,
                 normalizer: Optional[Normalizer] = None, device="cuda"):
        from tcdiff_torch.data.synthetic import synthetic_motion, synthetic_music

        pos, _ = synthetic_motion(n, dancer_num, seq_len, seed)
        roots = rotate_points_x90(torch.from_numpy(pos).to(device))
        self.roots, self.normalizer = _normalize_roots(roots, normalizer, True)
        self.music = synthetic_music(n, 2 * seq_len + 1, seed=seed + 1)
        self.feature_files = [f"synthetic_{i}_slice0.npy" for i in range(n)]
        self.wav_files = [f"synthetic_{i}_slice0.wav" for i in range(n)]

    def __len__(self):
        return len(self.roots)

    def get(self, idx: int):
        return self.roots[idx], self.music[idx], self.feature_files[idx], self.wav_files[idx]

    def batches(self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = True,
                rows: Optional[Rows] = None):
        return _batches(self, batch_size, rng, drop_last, lambda idx: self.music[idx], rows)
