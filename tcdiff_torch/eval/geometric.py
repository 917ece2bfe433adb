"""Boolean geometric (relational) motion features: the FID_g feature map.

The port of `tcdiff_tpu/eval/geometric.py`: the 32 boolean relational
features of Müller et al., "Efficient content-based retrieval of motion
capture data" (SIGGRAPH 2005), on the 24-joint SMPL skeleton, as the
AIST++/Bailando evaluation stack instantiates them
(google/aistplusplus_api `features/manual.py`). Same feature list,
thresholds and special joints; here vectorized over frames and over any
leading dims (clips, dancers) on the tensor's device.

Each feature is a predicate evaluated per frame (frames 1..T-1, since some
need a finite-difference velocity); the clip's feature vector is each
predicate's firing fraction over the frames.

Relational primitives:

  f_move(j1, j2, j3, j4, thr)   velocity of j4 relative to j3, projected on
                                the direction j2-j1, above thr (units/s)
  f_nmove(j1, j2, j3, j4, thr)  velocity of j4 relative to j1, projected on
                                the normal of the plane (j1, j2, j3), above thr
  f_plane(j1, j2, j3, j4, thr)  signed distance of j4 from the plane
                                through (j1, j2, j3) above thr
  f_nplane(j1, j2, j3, j4, thr) signed distance of j4 from the plane with
                                normal j2-j1 anchored at j3 above thr
  f_angle(j1, j2, k1, k2, rng)  angle between segments j2-j1 and k2-k1
                                inside the open range (rng0, rng1) degrees
  f_fast(j, thr)                speed of j above thr (units/s)

Special "joints": `zero` (origin), `up`/`down` (unit vectors), `floor`
(each frame's lowest joint height on the up axis).

Skeleton-relative thresholds use the humerus length (HL), shoulder width
(SW) and hip width (HW) of the rest pose of `geometry/skeleton.py`'s
`SMPL_OFFSETS`. Input joints are Z-up at 30 FPS, rotated to Y-up inside so
that the cross products' handedness matches the AIST++ code.

Every feature is a threshold test, so `geometric_feature_margins` gives
the tested quantity's signed distance from its threshold (for an angle,
from the nearer end of its range): a feature fires where its margin is
above 0. Two runs of the same joints on different hardware may differ in
the last bits, and so flip a feature whose margin is within those bits of
0; `flips_off_band` counts the disagreements that no such rounding
explains.
"""

from __future__ import annotations

import numpy as np
import torch

from tcdiff_torch.geometry.skeleton import SMPL_JOINTS, SMPL_OFFSETS, SMPL_PARENTS

FPS = 30

J = {name: i for i, name in enumerate(SMPL_JOINTS)}


def _rest_pose() -> np.ndarray:
    """World rest-pose joint positions: parent-chain sums of the offsets."""
    rest = np.zeros_like(SMPL_OFFSETS)
    for j in range(1, len(SMPL_PARENTS)):
        rest[j] = rest[SMPL_PARENTS[j]] + SMPL_OFFSETS[j]
    return rest


_REST = _rest_pose()
HL = float(np.linalg.norm(_REST[J["lelbow"]] - _REST[J["lshoulder"]]))  # humerus length
SW = float(np.linalg.norm(_REST[J["lshoulder"]] - _REST[J["rshoulder"]]))  # shoulder width
HW = float(np.linalg.norm(_REST[J["lhip"]] - _REST[J["rhip"]]))  # hip width

_EPS = 1e-10

# the 32 features of aistplusplus_api features/manual.py: (op, args...,
# threshold and its scale, or an angle range in degrees)
FEATURE_SPECS = (
    ("nmove", "neck", "rhip", "lhip", "rwrist", 1.8, "hl"),
    ("nmove", "neck", "lhip", "rhip", "lwrist", 1.8, "hl"),
    ("nplane", "chest", "neck", "neck", "rwrist", 0.2, "hl"),
    ("nplane", "chest", "neck", "neck", "lwrist", 0.2, "hl"),
    ("move", "belly", "chest", "chest", "rwrist", 1.8, "hl"),
    ("move", "belly", "chest", "chest", "lwrist", 1.8, "hl"),
    ("angle", "relbow", "rshoulder", "relbow", "rwrist", (0.0, 110.0)),
    ("angle", "lelbow", "lshoulder", "lelbow", "lwrist", (0.0, 110.0)),
    ("nplane", "lshoulder", "rshoulder", "lwrist", "rwrist", 2.5, "sw"),
    ("move", "lwrist", "rwrist", "rwrist", "lwrist", 1.4, "hl"),
    ("move", "rwrist", "root", "lwrist", "root", 1.4, "hl"),
    ("move", "lwrist", "root", "rwrist", "root", 1.4, "hl"),
    ("fast", "rwrist", 2.5, "hl"),
    ("fast", "lwrist", 2.5, "hl"),
    ("plane", "root", "lhip", "ltoes", "rankle", 0.38, "hl"),
    ("plane", "root", "rhip", "rtoes", "lankle", 0.38, "hl"),
    ("nplane", "zero", "up", "floor", "rankle", 1.2, "hl"),
    ("nplane", "zero", "up", "floor", "lankle", 1.2, "hl"),
    ("nplane", "lhip", "rhip", "lankle", "rankle", 2.1, "hw"),
    ("angle", "rknee", "rhip", "rknee", "rankle", (0.0, 110.0)),
    ("angle", "lknee", "lhip", "lknee", "lankle", (0.0, 110.0)),
    ("fast", "rankle", 2.5, "hl"),
    ("fast", "lankle", 2.5, "hl"),
    ("angle", "neck", "root", "rshoulder", "relbow", (25.0, 180.0)),
    ("angle", "neck", "root", "lshoulder", "lelbow", (25.0, 180.0)),
    ("angle", "neck", "root", "rhip", "rknee", (50.0, 180.0)),
    ("angle", "neck", "root", "lhip", "lknee", (50.0, 180.0)),
    ("plane", "rankle", "neck", "lankle", "root", 0.5, "hl"),
    ("angle", "neck", "root", "zero", "up", (70.0, 110.0)),
    ("nplane", "zero", "down", "floor", "rwrist", -1.2, "hl"),
    ("nplane", "zero", "down", "floor", "lwrist", -1.2, "hl"),
    ("fast", "root", 2.3, "hl"),
)

NUM_GEOMETRIC_FEATURES = len(FEATURE_SPECS)  # 32

_SCALES = {"hl": HL, "sw": SW, "hw": HW}

# a feature may differ between two runs only where its margin is within
# this of 0, in the feature's units (units, units/s or degrees): f32
# rounding of positions of order 1 moves a margin by about 1e-5 at most
MARGIN_BAND = 1e-4


def _thr(spec) -> float:
    return spec[-2] * _SCALES[spec[-1]]


def _fetch(joints: torch.Tensor, name: str) -> torch.Tensor:
    """(..., T, 24, 3) Y-up joints -> (..., T, 3) positions of a joint or special."""
    shape = joints.shape[:-2] + (3,)
    if name == "zero":
        return joints.new_zeros(shape)
    if name in ("up", "down"):
        return joints.new_tensor([0.0, 1.0 if name == "up" else -1.0, 0.0]).expand(shape)
    if name == "floor":
        ymin = joints[..., 1].amin(-1)  # each frame's lowest joint
        zero = torch.zeros_like(ymin)
        return torch.stack([zero, ymin, zero], dim=-1)
    return joints[..., J[name], :]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(_EPS)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def geometric_feature_margins(joints: torch.Tensor, fps: int = FPS) -> torch.Tensor:
    """(..., T, 24, 3) Z-up joint positions -> (..., T-1, 32) float32
    margins: each feature's tested quantity minus its threshold, and for an
    angle range the distance (degrees) inside its nearer end. Frame f's row
    uses positions at frame f and velocities f-1 -> f."""
    joints = torch.as_tensor(joints)
    # Z-up -> Y-up by the proper rotation (x, y, z) -> (x, z, -y), the
    # inverse of the dataset's Y-up -> Z-up rotation
    joints = torch.stack([joints[..., 0], joints[..., 2], -joints[..., 1]], dim=-1).float()
    names = {a for spec in FEATURE_SPECS for a in spec[1:] if isinstance(a, str) and a not in _SCALES}
    cur, prev = {}, {}
    for name in names:
        p = _fetch(joints, name)
        cur[name], prev[name] = p[..., 1:, :], p[..., :-1, :]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)

    def move(j1, j2, j3, j4):
        vel = (cur[j4] - cur[j3]) - (prev[j4] - prev[j3])
        return _dot(vel, _norm(cur[j2] - cur[j1])) * fps

    def nmove(j1, j2, j3, j4):
        vel = (cur[j4] - cur[j1]) - (prev[j4] - prev[j1])
        return _dot(vel, _norm(cross(cur[j3] - cur[j1], cur[j2] - cur[j1]))) * fps

    def plane(j1, j2, j3, j4):
        return _dot(cur[j4] - cur[j1], _norm(cross(cur[j3] - cur[j1], cur[j2] - cur[j1])))

    def nplane(j1, j2, j3, j4):
        return _dot(cur[j4] - cur[j3], _norm(cur[j2] - cur[j1]))

    def fast(j):
        return torch.linalg.vector_norm(cur[j] - prev[j], dim=-1) * fps

    ops = {"move": move, "nmove": nmove, "plane": plane, "nplane": nplane}
    cols = []
    for spec in FEATURE_SPECS:
        op = spec[0]
        if op == "angle":
            cos = _dot(_norm(cur[spec[2]] - cur[spec[1]]), _norm(cur[spec[4]] - cur[spec[3]])).clamp(-1.0, 1.0)
            deg = torch.rad2deg(torch.arccos(cos))
            lo, hi = spec[5]
            cols.append(torch.minimum(deg - lo, hi - deg))  # > 0 exactly where lo < deg < hi
        elif op == "fast":
            cols.append(fast(spec[1]) - _thr(spec))
        else:
            cols.append(ops[op](*spec[1:5]) - _thr(spec))  # > 0 exactly where the quantity > thr
    return torch.stack(cols, dim=-1)


def geometric_feature_frames(joints: torch.Tensor, fps: int = FPS) -> torch.Tensor:
    """(..., T, 24, 3) Z-up joints -> (..., T-1, 32) boolean feature matrix."""
    return geometric_feature_margins(joints, fps) > 0


def boolean_geometric_features(joints: torch.Tensor, fps: int = FPS) -> torch.Tensor:
    """(..., T, 24, 3) Z-up joints -> (..., 32) each feature's firing
    fraction over the frames: the clip-level FID_g feature vector."""
    return geometric_feature_frames(joints, fps).float().mean(-2)


def flips_off_band(frames, ref_frames, ref_margins, band: float = MARGIN_BAND) -> int:
    """The number of entries where two boolean feature matrices disagree
    although the reference's margin is farther than `band` from 0: a
    disagreement that no rounding explains. Any shapes that broadcast;
    tensors or arrays."""
    frames, ref_frames, ref_margins = (torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a.cpu()
                                       for a in (frames, ref_frames, ref_margins))
    return int(((frames != ref_frames) & (ref_margins.abs() > band)).sum())
