"""Top-down trajectory renders for the DBN stage.

The port of `tcdiff_tpu/viz/traj_render.py` (after the reference's
`TrajDecoder/vis.py:101-430`): an animated top-down view of each dancer's
XY root trace (a color a dancer, the current position marked), written as
GIF, and the per-sample `{"smpl_trans": ...}` pkl the reference dumps for
downstream tools. matplotlib is imported only to draw; the pkl needs
none.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_COLORS = ["tab:red", "tab:green", "tab:blue", "tab:orange", "tab:purple",
           "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


def traj_render(traj: np.ndarray, out: str = "renders", epoch=0, name: Optional[str] = None, fps: int = 30,
                trail: int = 45) -> str:
    """traj: (dn, T, 2) XY. Writes `<out>/traj_<epoch>_<name>.gif`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    traj = np.asarray(traj)
    dn, t, _ = traj.shape
    Path(out).mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 5))
    pad = 0.5
    ax.set_xlim(traj[..., 0].min() - pad, traj[..., 0].max() + pad)
    ax.set_ylim(traj[..., 1].min() - pad, traj[..., 1].max() + pad)
    ax.set_aspect("equal")
    ax.set_title("root trajectories (top-down)")
    lines = [ax.plot([], [], color=_COLORS[d % 10], lw=1.5)[0] for d in range(dn)]
    dots = [ax.plot([], [], "o", color=_COLORS[d % 10], ms=6)[0] for d in range(dn)]

    def update(i):
        lo = max(0, i - trail)
        for d in range(dn):
            lines[d].set_data(traj[d, lo:i + 1, 0], traj[d, lo:i + 1, 1])
            dots[d].set_data(traj[d, i:i + 1, 0], traj[d, i:i + 1, 1])
        return lines + dots

    anim = animation.FuncAnimation(fig, update, frames=t, blit=True)
    stem = os.path.splitext(os.path.basename(name))[0] if name else "sample"
    path = os.path.join(out, f"traj_{epoch}_{stem}.gif")
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def render_traj_sample(trajs: np.ndarray, out: str, epoch=0, names: Optional[Sequence[str]] = None,
                       pkl_out: Optional[str] = None, render: bool = True, max_renders: int = 2) -> list:
    """trajs: (b, dn, T, 2) rollouts. Renders the first `max_renders` and,
    with pkl_out, writes `{epoch}_{stem}.pkl` = {"smpl_trans": (dn, T, 3),
    z zero} a sample. Returns the paths written."""
    trajs = np.asarray(trajs)
    written = []
    for i in range(trajs.shape[0]):
        name = names[i] if names is not None else f"sample{i}"
        if render and i < max_renders:
            written.append(traj_render(trajs[i], out, epoch=epoch, name=name))
        if pkl_out:
            Path(pkl_out).mkdir(parents=True, exist_ok=True)
            stem = os.path.splitext(os.path.basename(name))[0]
            trans = np.concatenate([trajs[i], np.zeros_like(trajs[i][..., :1])], axis=-1)
            path = os.path.join(pkl_out, f"{epoch}_{stem}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"smpl_trans": trans}, f)
            written.append(path)
    return written
