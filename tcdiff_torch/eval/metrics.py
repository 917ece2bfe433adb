"""Quality metrics for generated group choreography.

The port of `tcdiff_tpu/eval/metrics.py`, the paper's quality axes:

  * kinetic motion features (each joint's and axis's mean kinetic energy,
    the `FID_k` feature map of the AIST++/Bailando evaluation code) and
    the boolean geometric features (`eval/geometric.py`, the `FID_g`
    feature map), both on the joints' device, over any leading dims;
  * the Fréchet distance of two feature sets, on the host in float64;
  * diversity (mean pairwise feature distance);
  * the beat-alignment score between music beats and kinematic beats
    (local minima of the mean joint speed), on the host;
  * foot skating and inter-dancer collision frequency, and the group
    motion consistency, on the device.

Joints are FK positions (..., T, 24, 3), Z-up, at 30 FPS. The functions
take tensors (on any device) or arrays (then on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from tcdiff_torch.config import FOOT_JOINTS
from tcdiff_torch.eval.geometric import boolean_geometric_features

FPS = 30


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------ feature maps
def kinetic_features(joints) -> torch.Tensor:
    """(..., T, 24, 3) joint positions -> (..., 72) per-joint mean kinetic
    energy: E[j, axis] = mean_t 0.5 v[t, j, axis]^2, v in units/s."""
    joints = _tensor(joints).float()
    vel = (joints[..., 1:, :, :] - joints[..., :-1, :, :]) * FPS
    return (0.5 * (vel ** 2).mean(-3)).flatten(-2)


def geometric_features(joints) -> torch.Tensor:
    """(..., T, 24, 3) -> (..., 32) boolean relational features (firing
    fractions), the FID_g feature map. Its thresholds come from this
    skeleton's rest pose, not from google/aistplusplus_api, so absolute
    FID_g values need not match published tables: compare values taken
    under the one feature map."""
    return boolean_geometric_features(_tensor(joints))


def extract_features(joints_batch, kind: str = "kinetic") -> np.ndarray:
    """(N, T, 24, 3) or (N, dn, T, 24, 3) -> (N*, D) float32 feature
    matrix, computed on the joints' device."""
    arr = _tensor(joints_batch)
    if arr.dim() == 5:
        arr = arr.reshape((-1,) + tuple(arr.shape[2:]))
    fn = kinetic_features if kind == "kinetic" else geometric_features
    return _host(fn(arr))


# ------------------------------------------------------------------- FID
def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between Gaussian fits of two feature sets, in
    float64 on the host: sqrtm(S1 S2) with the eps ridge added ONLY where
    the plain product's root is not finite (adding it always biases
    FID(X, X) away from 0), the TTUR/pytorch-fid recipe."""
    from scipy import linalg

    feats_a, feats_b = _host(feats_a), _host(feats_b)
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.atleast_2d(np.cov(feats_a, rowvar=False))
    s2 = np.atleast_2d(np.cov(feats_b, rowvar=False))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        eps = 1e-6 * np.eye(s1.shape[0])
        covmean = linalg.sqrtm((s1 + eps) @ (s2 + eps))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1 + s2 - 2.0 * covmean))


def diversity(feats: np.ndarray, max_pairs: int = 10_000, seed: int = 0) -> float:
    """Mean euclidean distance of random pairs of distinct feature rows
    (numpy's default_rng(seed))."""
    feats = _host(feats)
    n = len(feats)
    if n < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, size=min(max_pairs, n * (n - 1)))
    j = rng.integers(0, n, size=len(i))
    keep = i != j
    return float(np.linalg.norm(feats[i[keep]] - feats[j[keep]], axis=1).mean())


# --------------------------------------------------------- beat alignment
def kinematic_beats(joints, fps: int = FPS) -> np.ndarray:
    """Frame indices of kinematic beats: local minima of the mean joint
    speed (T, 24, 3) -> indices, on the host."""
    arr = _host(joints)
    vel = np.linalg.norm(np.diff(arr, axis=0), axis=-1).mean(axis=-1) * fps  # (T-1,)
    minima = (vel[1:-1] < vel[:-2]) & (vel[1:-1] <= vel[2:])
    return np.where(minima)[0] + 1


def beat_alignment_score(joints, music_beat_frames: np.ndarray, sigma: float = 3.0) -> float:
    """mean_b exp(-min_k (t_b - t_k)^2 / (2 sigma^2)) over MUSIC beats b and
    kinematic beats k (frames at 30 FPS): the AIST++ BeatAlign score."""
    music = np.asarray(music_beat_frames, dtype=np.float64)
    kin = kinematic_beats(joints).astype(np.float64)
    if len(music) == 0 or len(kin) == 0:
        return 0.0
    d = np.abs(music[:, None] - kin[None, :]).min(axis=1)
    return float(np.mean(np.exp(-(d ** 2) / (2 * sigma ** 2))))


def music_beats_from_features(music_feats, motion_fps: int = FPS) -> np.ndarray:
    """Motion-frame indices of the beats of the 438-d features' one-hot
    beat channel (index 53; the music runs at 2x the motion's FPS)."""
    beat_channel = _host(music_feats)[:, 53]
    return np.where(beat_channel > 0.5)[0] // 2


# -------------------------------------------------- physical plausibility
def foot_skating_ratio(joints, height_thresh: float = 0.05, vel_thresh: float = 0.075) -> torch.Tensor:
    """(..., T, 24, 3) -> (...,) the share of foot-grounded frames where the
    foot still slides. A foot is grounded below its own lowest height plus
    height_thresh (strictly); it skates where its horizontal speed is above
    vel_thresh units/s while grounded."""
    feet = _tensor(joints)[..., FOOT_JOINTS, :]  # (..., T, 4, 3)
    z = feet[..., 2]
    grounded = z[..., :-1, :] < (z.amin(-2, keepdim=True) + height_thresh)
    vel = torch.linalg.vector_norm(feet[..., 1:, :, :2] - feet[..., :-1, :, :2], dim=-1) * FPS
    skating = grounded & (vel > vel_thresh)
    return skating.sum((-2, -1)) / grounded.sum((-2, -1)).clamp_min(1)


def collision_frequency(root_pos, radius: float = 0.4) -> torch.Tensor:
    """(..., dn, T, >=2) root positions -> (...,) the share of frames where
    any two dancers are closer than `radius` in XY: the group-dance
    trajectory-intersection metric."""
    xy = _tensor(root_pos)[..., :2]
    d = torch.linalg.vector_norm(xy[..., :, None, :, :] - xy[..., None, :, :, :], dim=-1)  # (..., dn, dn, T)
    dn = xy.shape[-3]
    off = ~torch.eye(dn, dtype=torch.bool, device=xy.device)
    close = (d < radius) & off[:, :, None]
    return close.any(-2).any(-2).float().mean(-1)


def _consistency(feats: torch.Tensor) -> torch.Tensor:
    """(..., dn, D) feature rows -> (...,) mean pairwise cosine similarity."""
    dn = feats.shape[-2]
    if dn < 2:
        return feats.new_ones(feats.shape[:-2])
    unit = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp_min(1e-10)
    sim = unit @ unit.transpose(-1, -2)
    off = ~torch.eye(dn, dtype=torch.bool, device=feats.device)
    return sim[..., off].mean(-1)


def group_motion_consistency(joints_group) -> float:
    """Mean pairwise cosine similarity of the dancers' kinetic feature
    vectors within one group (dn, T, 24, 3): high where the dancers move in
    a coordinated way (the GMC axis of group-dance evaluation)."""
    return float(_consistency(kinetic_features(joints_group)))


# ----------------------------------------------------------------- report
def evaluate(gen_joints, ref_joints, music_feats=None, gen_roots=None) -> dict:
    """The full metric report, with the JAX package's keys.

    gen/ref_joints: (N, dn, T, 24, 3) FK positions; music_feats: a list or
    array of (F, 438) a sample; gen_roots: (N, dn, T, 3) for collisions.
    The feature maps, skating, collisions and consistency run on the
    joints' device; the distances, the beats and the means on the host."""
    gen, ref = _tensor(gen_joints), _tensor(ref_joints)
    fk_gen, fk_ref = extract_features(gen, "kinetic"), extract_features(ref, "kinetic")
    fg_gen, fg_ref = extract_features(gen, "geometric"), extract_features(ref, "geometric")
    out = {
        "fid_k": frechet_distance(fk_gen, fk_ref),
        "fid_g": frechet_distance(fg_gen, fg_ref),
        "div_k": diversity(fk_gen),
        "div_g": diversity(fg_gen),
        "foot_skate": float(np.mean(_host(foot_skating_ratio(gen)).astype(np.float64).reshape(-1))),
    }
    if music_feats is not None:
        gen_host = _host(gen)
        scores = []
        for sample, mf in zip(gen_host, music_feats):
            beats = music_beats_from_features(mf)
            scores.append(np.mean([beat_alignment_score(d, beats) for d in sample]))
        out["beat_align"] = float(np.mean(scores))
    if gen_roots is not None:
        out["collision_freq"] = float(np.mean(_host(collision_frequency(_tensor(gen_roots))).astype(np.float64)))
    out["gmc"] = float(np.mean(_host(_consistency(kinetic_features(gen))).astype(np.float64)))
    return out
