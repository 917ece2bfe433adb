"""Host-side stick-figure renderer.

The port of `tcdiff_tpu/viz/render.py`, a behavioral copy of the
reference's matplotlib renderer (`vis.py:104-327`): colored 3D skeletons a
dancer, foot-contact dots (red = in contact), the root's trace, a 30 FPS
animation written as GIF through Pillow, and, where an `ffmpeg` binary is
on the PATH and the audio exists, muxed with the (stitched) audio into an
mp4 as the reference does (`vis.py:320`). Audio is read and written with
scipy.io.wavfile.

matplotlib is imported only to draw (`render=True`): the contact labels
and `render=False` need none, and without matplotlib `render=True`
raises ImportError.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from tempfile import TemporaryDirectory

import numpy as np

from tcdiff_torch.config import FOOT_JOINTS
from tcdiff_torch.geometry.skeleton import SMPL_PARENTS

COLORS = ["#e3ba8f", "#ff6b6b", "#0abde3", "#576574", "#01a3a4"]


def _load_wav(path):
    from scipy.io import wavfile

    sr, audio = wavfile.read(path)
    if audio.dtype.kind == "i":
        audio = audio.astype(np.float32) / np.iinfo(audio.dtype).max
    elif audio.dtype.kind == "u":
        audio = (audio.astype(np.float32) - 128.0) / 128.0
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    return audio.astype(np.float32), sr


def _write_wav(path, audio, sr):
    from scipy.io import wavfile

    wavfile.write(path, sr, np.clip(audio, -1, 1).astype(np.float32))


def _stitch_audio(names, out_path):
    """Half-overlap audio concatenation (`vis.py:299-312`)."""
    name_ = [os.path.splitext(x)[0] + ".wav" for x in names]
    audio, sr = _load_wav(name_[0])
    ll, half = len(audio), len(audio) // 2
    total = np.zeros(ll + half * (len(name_) - 1), np.float32)
    total[:ll] = audio
    idx = ll
    for n_ in name_[1:]:
        audio, _ = _load_wav(n_)
        total[idx:idx + half] = audio[half:]
        idx += half
    _write_wav(out_path, total, sr)


def skeleton_render(poses, epoch=0, out="renders", name="", sound=True, stitch=False, sound_folder="ood_sliced",
                    contact=None, render=True, fps=30):
    """poses: (dn, S, 24, 3) numpy, several dancers, or (S, 24, 3) one.

    Writes `<out>/<epoch>_<name>.gif` (and .mp4 where ffmpeg and the audio
    exist) and returns its path; with render=False writes nothing and
    returns None."""
    poses = np.asarray(poses)
    multi = poses.ndim == 4
    dn = poses.shape[0] if multi else 1
    poses4 = poses if multi else poses[None]
    n_frames = poses4.shape[1]
    if contact is None:  # a foot joint in contact where it moves under 0.01 a frame (`vis.py:278-286`)
        feet = poses4[:, :, list(FOOT_JOINTS)]
        feetv = np.zeros(feet.shape[:3])
        feetv[:, :-1] = np.linalg.norm(feet[:, 1:] - feet[:, :-1], axis=-1)
        contact = feetv < 0.01
    elif contact.ndim == 2:
        contact = contact[None]
    if not render:
        return None

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    Path(out).mkdir(parents=True, exist_ok=True)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=40, azim=-90)
    lines = [[ax.plot([], [], [], zorder=10, linewidth=4.0, color=COLORS[d % len(COLORS)])[0] for _ in SMPL_PARENTS]
             for d in range(dn)]
    scat = [ax.scatter([], [], [], zorder=10, s=12) for _ in range(4 * dn)]
    axrange = 4.0
    ax.set_xlim(-axrange / 2, axrange / 2)
    ax.set_ylim(-axrange / 2, axrange / 2)
    ax.set_zlim(2.5 - axrange / 2, 2.5 + axrange / 2)

    def update(num):
        pose = poses4[:, num]  # (dn, 24, 3)
        for d in range(dn):
            for i, p in enumerate(SMPL_PARENTS):
                if i == 0:
                    if num > 1:  # the root's trace
                        lines[d][0].set_data(poses4[d, :num, 0, :2].T)
                        lines[d][0].set_3d_properties(np.zeros(num))
                    continue
                seg = np.stack([pose[d, i], pose[d, p]])
                lines[d][i].set_data(seg[:, :2].T)
                lines[d][i].set_3d_properties(seg[:, 2])
            for i, idx in enumerate(FOOT_JOINTS):
                pt = pose[d, idx:idx + 1]
                scat[d * 4 + i].set_offsets(pt[:, :2])
                scat[d * 4 + i].set_3d_properties(pt[:, 2], "z")
                scat[d * 4 + i].set_facecolors(["r" if contact[d, num, i] else "g"])
        return []

    anim = animation.FuncAnimation(fig, update, frames=n_frames, interval=1000 // fps)
    fig.tight_layout()
    if stitch and isinstance(name, (list, tuple)):
        base = "_".join(os.path.splitext(os.path.basename(name[0]))[0].split("_")[:-1])
    elif isinstance(name, str) and name:
        base = os.path.splitext(os.path.basename(name))[0]
    else:
        base = "sample"
    gifname = os.path.join(out, f"{epoch}_{base}.gif")
    anim.save(gifname, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)

    outname = gifname
    ffmpeg = shutil.which("ffmpeg")
    if sound and ffmpeg:
        with TemporaryDirectory() as td:
            if stitch and isinstance(name, (list, tuple)):
                audioname = os.path.join(td, "tempsound.wav")
                try:
                    _stitch_audio(list(name), audioname)
                except (FileNotFoundError, ValueError):
                    audioname = None
            else:
                audioname = name if isinstance(name, str) and os.path.exists(name) else None
            if audioname:
                mp4 = os.path.join(out, f"{epoch}_{base}.mp4")
                os.system(f"{ffmpeg} -loglevel error -stream_loop 0 -y -i {gifname} "
                          f"-i {audioname} -shortest -c:v libx264 -c:a libmp3lame -q:a 4 {mp4}")
                outname = mp4
    return outname
