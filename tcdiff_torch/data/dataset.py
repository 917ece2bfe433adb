"""AIOZ-GDance dataset: host-side loading, processing on the card.

The port of `tcdiff_tpu/data/dataset.py`, which rebuilds the reference's
`AIOZDataset` (`dataset/group_dataset.py:23-238`):

  * load the 5 s motion slices (pkl: pos (dn, 150, 3), q (dn, 150, 72)),
    filtered by a dancer-count split file and by the existence of the
    matching feats438 music-feature file;
  * rotate the Y-up AIOZ data to Z-up (root orientation and root
    positions);
  * run SMPL FK and threshold the foot velocities (< 0.01) into contact
    labels;
  * convert the joint rotations to 6D and pack [contacts(4), root(3),
    rot6d(144)] = 151 channels;
  * min-max normalize to [-1, 1].

The JAX package processes the whole dataset in one jitted call; here the
slices go through the same batched function in chunks along the slice
axis (every operation is per slice, so a chunk size changes no bit), on
the device the caller names.

Quirk kept for parity: the reference re-fits the train normalizer on every
sequence, so each train sample is normalized by its OWN min/max and the
*last* sequence's stats become the dataset's normalizer
(`group_dataset.py:216-218`, `docs/COMPONENTS.md` #9).
`per_sample_normalization=True` (the default) keeps that; False fits once
over the whole split.
"""

from __future__ import annotations

import glob
import os
import pickle
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from tcdiff_torch.config import FOOT_JOINTS, N_JOINTS
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.geometry.rotations import (
    axis_angle_to_quaternion, ax_to_6v, quat_multiply, quaternion_to_axis_angle,
)
from tcdiff_torch.geometry.skeleton import smpl_fk
from tcdiff_torch.parallel.mesh import Rows

# 90 degrees about +X as a wxyz quaternion: rotates Y-up into Z-up
# (reference `group_dataset.py:186-198`)
_YUP_TO_ZUP_QUAT = np.array([0.7071068, 0.7071068, 0.0, 0.0], dtype=np.float32)
CONTACT_VELOCITY = 0.01  # a foot joint moving less than this a frame is in contact
CHUNK = 256  # slices processed a call


def rotate_points_x90(points: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> (x, -z, y): the reference's RotateAxisAngle(90, 'X')."""
    x, y, z = points.unbind(-1)
    return torch.stack([x, -z, y], dim=-1)


def _foot_velocity(positions: torch.Tensor) -> torch.Tensor:
    """(..., S, 24, 3) joint positions -> (..., S, 4): each foot joint's
    distance moved to the next frame, 0 on the last frame."""
    feet = positions[..., list(FOOT_JOINTS), :]
    d = feet[..., 1:, :, :] - feet[..., :-1, :, :]
    vel = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    return torch.cat([vel, torch.zeros_like(vel[..., :1, :])], dim=-2)


def _process_one(root_pos: torch.Tensor, local_q: torch.Tensor) -> torch.Tensor:
    """(..., S, 3) root positions, (..., S, 24, 3) axis-angle ->
    (..., S, 151) unnormalized, over any leading dims (a sequence's
    dancers, a batch of sequences)."""
    zup = torch.as_tensor(_YUP_TO_ZUP_QUAT, device=local_q.device)
    root_aa = quaternion_to_axis_angle(quat_multiply(zup, axis_angle_to_quaternion(local_q[..., 0, :])))
    local_q = torch.cat([root_aa[..., None, :], local_q[..., 1:, :]], dim=-2)
    root_pos = rotate_points_x90(root_pos)

    # foot contacts from FK velocities (`group_dataset.py:201-207`)
    feetv = _foot_velocity(smpl_fk(local_q, root_pos))
    contacts = (feetv < CONTACT_VELOCITY).to(local_q.dtype)
    rot6d = ax_to_6v(local_q).flatten(-2)  # (..., S, 144)
    return torch.cat([contacts, root_pos, rot6d], dim=-1)


def _process_batch(root_pos: torch.Tensor, local_q: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """(N, dn, S, 3), (N, dn, S, 24, 3) -> (N, dn, S, 151) unnormalized, on
    the inputs' device, `chunk` slices a call."""
    return torch.cat([_process_one(p, q) for p, q in zip(root_pos.split(chunk), local_q.split(chunk))])


def _per_sample_normalize(packed: torch.Tensor):
    """Normalize each sequence by its own min/max (the train split's parity
    quirk): one vectorised min/max a sample, `Normalizer.fit`'s arithmetic.

    packed: (N, ..., C). Returns the normalized data and the LAST sample's
    normalizer (what the reference ends up with as `self.normalizer`)."""
    flat = packed.reshape(packed.shape[0], -1, packed.shape[-1])
    data_min = flat.amin(dim=1)
    data_range = flat.amax(dim=1) - data_min
    eps = 10 * torch.finfo(flat.dtype).eps
    safe_range = torch.where(data_range < eps, torch.ones_like(data_range), data_range)
    lo, hi = Normalizer.feature_range
    scale = (hi - lo) / safe_range
    offset = lo - data_min * scale
    bshape = (packed.shape[0],) + (1,) * (packed.dim() - 2) + (packed.shape[-1],)
    normalized = (packed * scale.reshape(bshape) + offset.reshape(bshape)).clamp(lo, hi)
    return normalized, Normalizer(scale=scale[-1].clone(), offset=offset[-1].clone())


def load_split_file(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _load_slices(data_path: str, train: bool, required_dancer_num: int, split_file, keys):
    """The split's motion slices with a feats438 file and the required
    dancer count, sorted by name: ({key: [array]}, feature files, wav
    files)."""
    split_dir = os.path.join(data_path, "train" if train else "test")
    motion_dir = os.path.join(split_dir, "motions_sliced")
    feats_dir = os.path.join(split_dir, "feats438")
    wav_dir = os.path.join(split_dir, "wavs_sliced")
    arrays, names, wavs = {k: [] for k in keys}, [], []
    for motion_p in sorted(glob.glob(os.path.join(motion_dir, "*.pkl"))):
        stem = os.path.splitext(os.path.basename(motion_p))[0]
        origin = "_".join(stem.split("_")[:-1])  # strip _sliceN
        if split_file is not None and origin not in split_file:
            continue
        feat_p = os.path.join(feats_dir, stem + ".npy")
        if not os.path.exists(feat_p):
            continue
        with open(motion_p, "rb") as f:
            data = pickle.load(f)
        if np.asarray(data["pos"]).shape[0] != required_dancer_num:
            continue
        for k in keys:
            arrays[k].append(np.asarray(data[k], dtype=np.float32))
        names.append(feat_p)
        wavs.append(os.path.join(wav_dir, stem + ".wav"))
    if not names:
        raise FileNotFoundError(f"no {required_dancer_num}-dancer motion slices under {motion_dir}")
    return arrays, names, wavs


class AIOZDataset:
    """In-memory dataset of processed motion slices and lazily loaded music
    features.

    Iteration yields dict batches of host arrays:
      x:    (B, dn, 150, 151) normalized motion, the reference's pose tensor
      cond: (B, 301, 438) music features
      filename / wav: lists of paths
    The slices are processed on `device` (the card unless the caller asks
    for the CPU), where the normalizer stays.
    """

    def __init__(self, data_path: str, train: bool, required_dancer_num: int = 3,
                 split_file: Optional[Sequence[str]] = None, normalizer: Optional[Normalizer] = None,
                 per_sample_normalization: bool = True, cache_features: bool = True, device="cuda"):
        self.train = train
        self.required_dancer_num = required_dancer_num
        self._feature_cache = {} if cache_features else None

        arrays, names, wavs = _load_slices(data_path, train, required_dancer_num, split_file, ("pos", "q"))
        pos = torch.from_numpy(np.stack(arrays["pos"])).to(device)  # (N, dn, S, 3)
        q = torch.from_numpy(np.stack(arrays["q"])).to(device)  # (N, dn, S, 72)
        packed = _process_batch(pos, q.reshape(q.shape[:3] + (N_JOINTS, 3)))

        if train:
            if per_sample_normalization:
                normalized, self.normalizer = _per_sample_normalize(packed)
            else:
                self.normalizer = Normalizer.fit(packed, device=packed.device)
                normalized = self.normalizer.normalize(packed)
        else:
            if normalizer is None:
                raise ValueError("the test split needs the train split's normalizer")
            self.normalizer = normalizer
            normalized = normalizer.normalize(packed)

        poses = normalized.cpu().numpy()
        if np.isnan(poses).any():
            raise ValueError(f"NaN in the processed motion of {data_path}")
        self.poses = poses  # (N, dn, S, 151)
        self.feature_files = names
        self.wav_files = wavs

    def __len__(self):
        return len(self.poses)

    # The reference pickles whole Dataset objects as a cache
    # (`TCDiff.py:143-173`); here the processed arrays go into one npz, in
    # the JAX package's format, so either package loads the other's.
    def save_cache(self, path: str) -> None:
        Path(os.path.dirname(path) or ".").mkdir(parents=True, exist_ok=True)
        stats = self.normalizer.to_numpy()
        np.savez_compressed(
            path,
            poses=self.poses,
            feature_files=np.asarray(self.feature_files),
            wav_files=np.asarray(self.wav_files),
            norm_scale=stats["scale"],
            norm_offset=stats["offset"],
            train=np.asarray(self.train),
        )

    @classmethod
    def from_cache(cls, path: str, device="cuda") -> "AIOZDataset":
        z = np.load(path, allow_pickle=False)
        self = cls.__new__(cls)
        self.train = bool(z["train"])
        self.poses = z["poses"]
        self.required_dancer_num = self.poses.shape[1]
        self.feature_files = [str(s) for s in z["feature_files"]]
        self.wav_files = [str(s) for s in z["wav_files"]]
        self.normalizer = Normalizer.from_torch_state(z["norm_scale"], z["norm_offset"], device=device)
        self._feature_cache = {}
        return self

    def _load_feature(self, path: str) -> np.ndarray:
        if self._feature_cache is not None and path in self._feature_cache:
            return self._feature_cache[path]
        feat = np.load(path).astype(np.float32)
        if self._feature_cache is not None:
            self._feature_cache[path] = feat
        return feat

    def get(self, idx: int):
        return (self.poses[idx], self._load_feature(self.feature_files[idx]), self.feature_files[idx],
                self.wav_files[idx])

    def batches(self, batch_size: int, rng: Optional[np.random.Generator] = None, drop_last: bool = True,
                rows: Optional[Rows] = None):
        """Shuffled epoch iterator over host numpy batches; with `rows` (a
        data-parallel rank's share of each global batch of `batch_size`)
        only those rows' files are read."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        for i in range(0, stop or len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            if rows is not None:
                idx = rows.take(idx)
            yield {
                "x": self.poses[idx],
                "cond": np.stack([self._load_feature(self.feature_files[j]) for j in idx]),
                "filename": [self.feature_files[j] for j in idx],
                "wav": [self.wav_files[j] for j in idx],
            }
