"""Sample post-processing: unnormalize, FK, long-form stitching, render,
FK pkl export.

The port of `tcdiff_tpu/viz/postprocess.py`, the back half of the
reference's `GaussianDiffusion.render_sample` (`model/diffusion.py:765-988`):
split off the contacts, 6D -> axis-angle, SMPL forward kinematics, the
long mode's half-window crossfade of root positions and quaternion slerp
of joint rotations (`model/diffusion.py:849-897`), the matplotlib render
and the pkl the Blender tools read (`model/diffusion.py:930-940,971-988`).

`postprocess_sample` does the arithmetic on the samples' device and hands
numpy arrays to `write_sample`, which only draws and writes files;
`render_sample` is the two in turn.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.geometry import ax_from_6v, axis_angle_to_quaternion, quat_slerp, quaternion_to_axis_angle, smpl_fk
from tcdiff_torch.viz.render import skeleton_render


def split_sample(samples: torch.Tensor, normalizer: Normalizer, dancer_num: int):
    """(b, seq*dn, 151) normalized -> (contacts, pos, q): contacts (b, seq,
    dn, 4), pos (b, seq*dn, 3), q (b, seq*dn, 24, 3) axis-angle, the
    reference's layout after `model/diffusion.py:811-838`."""
    b, tokens, c = samples.shape
    seq = tokens // dancer_num
    samples = normalizer.unnormalize(samples)
    contacts = samples.reshape(b, seq, dancer_num, c)[..., :4]
    rest = samples.reshape(b, seq, dancer_num, c)[..., 4:].reshape(b, tokens, c - 4)
    return contacts, rest[..., :3], ax_from_6v(rest[..., 3:].reshape(b, tokens, 24, 6))


def _linspace(start: float, stop: float, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(start, stop, n, dtype=like.dtype, device=like.device)


def stitch_long(pos: torch.Tensor, q: torch.Tensor):
    """Join b half-overlapping slices into one clip: the root positions
    crossfaded, the joint rotations slerped across each overlap in
    quaternion space (`model/diffusion.py:849-897`), on the inputs' device,
    all dancers at once.

    pos: (b, s, dn, 3); q: (b, s, dn, 24, 3) axis-angle; s even. Returns
    (L, dn, 3), (L, dn, 24, 3) with L = s + (s/2)(b-1)."""
    pos, q = torch.as_tensor(pos), torch.as_tensor(q)
    b, s, dn = pos.shape[:3]
    half = s // 2
    fade_out = torch.ones(s, dtype=pos.dtype, device=pos.device)
    fade_out[half:] = _linspace(1, 0, half, pos)
    fade_in = torch.ones(s, dtype=pos.dtype, device=pos.device)
    fade_in[:half] = _linspace(0, 1, half, pos)
    faded = pos.clone()
    faded[:-1] *= fade_out[None, :, None, None]
    faded[1:] *= fade_in[None, :, None, None]
    full_pos = pos.new_zeros((s + half * (b - 1), dn, 3))
    for i in range(b):  # overlap-add, in slice order
        full_pos[i * half:i * half + s] += faded[i]

    w = _linspace(0, 1, half, pos)[None, :, None, None]
    left = axis_angle_to_quaternion(q[:-1, half:])  # (b-1, half, dn, 24, 4)
    right = axis_angle_to_quaternion(q[1:, :half])
    merged = quaternion_to_axis_angle(quat_slerp(left, right, w))
    full_q = torch.cat([q[0, :half], merged.reshape((-1,) + tuple(q.shape[2:])), q[-1, half:]], dim=0)
    return full_pos, full_q


@dataclasses.dataclass
class Postprocessed:
    """What `write_sample` draws and writes, on the host.

    mode "normal": poses (b, dn, seq, 24, 3), contacts (b, dn, seq, 4), q
    (b, seq*dn, 24, 3), pos (b, seq*dn, 3). mode "long": poses (dn, L, 24,
    3) of the stitched clip, q (L*dn, 24, 3), pos (L*dn, 3), no contacts."""

    mode: str
    poses: np.ndarray
    q: np.ndarray
    pos: np.ndarray
    contacts: Optional[np.ndarray] = None


def fk_sample(samples: torch.Tensor, normalizer: Normalizer, dancer_num: int):
    """`split_sample`, then FK, on the samples' device: (contacts (b, dn,
    seq, 4), pos (b, seq*dn, 3), q (b, seq*dn, 24, 3), joints (b, dn, seq,
    24, 3))."""
    b, seq = samples.shape[0], samples.shape[1] // dancer_num
    contacts, pos, q = split_sample(samples, normalizer, dancer_num)
    joints = smpl_fk(q, pos).reshape(b, seq, dancer_num, 24, 3).transpose(1, 2)
    return contacts.transpose(1, 2), pos, q, joints


def postprocess_sample(samples: torch.Tensor, normalizer: Normalizer, dancer_num: int,
                       mode: str = "normal") -> Postprocessed:
    """Unnormalize, 6D -> axis-angle, (in long mode) stitch the b slices,
    FK; on the samples' device, then to the host."""
    if mode == "long":
        b, seq = samples.shape[0], samples.shape[1] // dancer_num
        _, pos, q = split_sample(samples, normalizer, dancer_num)
        full_pos, full_q = stitch_long(pos.reshape(b, seq, dancer_num, 3), q.reshape(b, seq, dancer_num, 24, 3))
        n = full_pos.shape[0]
        flat_pos, flat_q = full_pos.reshape(n * dancer_num, 3), full_q.reshape(n * dancer_num, 24, 3)
        poses = smpl_fk(flat_q, flat_pos).reshape(n, dancer_num, 24, 3).transpose(0, 1)
        return Postprocessed(mode, poses.cpu().numpy(), flat_q.cpu().numpy(), flat_pos.cpu().numpy())
    contacts, pos, q, poses = fk_sample(samples, normalizer, dancer_num)
    return Postprocessed(mode, poses.cpu().numpy(), q.cpu().numpy(), pos.cpu().numpy(), contacts.cpu().numpy())


def _dump(path: str, poses: np.ndarray, trans: np.ndarray, full_pose: np.ndarray) -> None:
    with open(path, "wb") as f:
        pickle.dump({"smpl_poses": poses.reshape(-1, 72), "smpl_trans": trans, "full_pose": full_pose}, f)


def write_sample(post: Postprocessed, epoch, render_out: str, fk_out: Optional[str] = None, name=None,
                 sound: bool = True, render: bool = True, render_len: int = 512) -> np.ndarray:
    """Draw (render=True) and write the FK pkls (fk_out) of a
    post-processed sample; host only. Long mode: one stitched render and
    `{fk_out}/{epoch}_{base}.pkl` (base: the first name's stem without its
    `_slice{i}` suffix). Normal mode: a render and
    `{fk_out}/{epoch}_{num}_{stem}.pkl` a sample. Each pkl holds
    smpl_poses (frames*dn, 72), smpl_trans (frames*dn, 3) and full_pose
    (dn, frames, 24, 3). Returns the poses."""
    if post.mode == "long":
        if render:
            skeleton_render(post.poses[:, :render_len], epoch=f"{epoch}", out=render_out, name=name, sound=sound,
                            stitch=True, render=render)
        if fk_out is not None:
            Path(fk_out).mkdir(parents=True, exist_ok=True)
            base = "_".join(os.path.splitext(os.path.basename(name[0]))[0].split("_")[:-1]) if name else "sample"
            _dump(os.path.join(fk_out, f"{epoch}_{base}.pkl"), post.q, post.pos, post.poses)
        return post.poses
    b = post.poses.shape[0]
    if render:
        for num in range(b):
            skeleton_render(post.poses[num], epoch=f"e{epoch}_b{num}", out=render_out,
                            name=name[num] if name is not None else None, sound=sound, contact=post.contacts[num])
    if fk_out is not None:
        Path(fk_out).mkdir(parents=True, exist_ok=True)
        for num in range(b):
            stem = os.path.splitext(os.path.basename(name[num]))[0] if name else f"sample{num}"
            _dump(os.path.join(fk_out, f"{epoch}_{num}_{stem}.pkl"), post.q[num], post.pos[num], post.poses[num])
    return post.poses


def render_sample(samples, normalizer: Normalizer, epoch, render_out: str, dancer_num: int,
                  fk_out: Optional[str] = None, name=None, sound: bool = True, mode: str = "normal",
                  render: bool = True, render_len: int = 512) -> np.ndarray:
    """Post-process and render already-drawn samples (b, seq*dn, 151),
    normalized (any sampler's output); in "long" mode b is the slice count
    and the slices are stitched into one clip. Returns the FK joints as
    numpy: (b, dn, seq, 24, 3), or (dn, L, 24, 3) in long mode."""
    samples = torch.as_tensor(samples, dtype=torch.float32, device=normalizer.device)
    post = postprocess_sample(samples, normalizer, dancer_num, mode)
    return write_sample(post, epoch, render_out, fk_out=fk_out, name=name, sound=sound, render=render,
                        render_len=render_len)
