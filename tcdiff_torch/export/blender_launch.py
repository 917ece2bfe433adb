"""Batch Blender retarget/render launcher (offline tooling, needs Blender).

A copy of `tcdiff_tpu/export/blender_launch.py` (after the reference's
`Blender_Visulization/4-launch.py:7-46` + `smpl2smplforLaunch.py`): for
every per-dancer animation file, run Blender headless with a script that
imports the animation and writes the scene. Works with the BVH exports of
`tcdiff_torch.export.bvh` (Blender imports BVH natively, no Auto-Rig Pro /
FBX SDK required) or with FBX files where those exist;
`blender_available()` says whether a `blender` binary is on the PATH.

The in-Blender script is emitted by `write_blender_import_script` so this
module has no bpy dependency itself.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
from pathlib import Path

_IMPORT_SCRIPT = '''\
"""Runs INSIDE Blender: import one animation and save a .blend scene."""
import sys

import bpy

argv = sys.argv[sys.argv.index("--") + 1 :]
anim_path, out_blend = argv[0], argv[1]

bpy.ops.wm.read_factory_settings(use_empty=True)
if anim_path.endswith(".bvh"):
    bpy.ops.import_anim.bvh(filepath=anim_path, rotate_mode="ZXY")
elif anim_path.endswith(".fbx"):
    bpy.ops.import_scene.fbx(filepath=anim_path)
else:
    raise SystemExit(f"unsupported animation format: {anim_path}")

# one material per armature so dancers are distinguishable, like the
# reference's per-dancer coloring (4-launch.py)
colors = [(0.9, 0.2, 0.2, 1), (0.2, 0.8, 0.3, 1), (0.2, 0.4, 0.9, 1),
          (0.9, 0.7, 0.1, 1), (0.7, 0.2, 0.8, 1)]
for i, obj in enumerate(bpy.data.objects):
    if obj.type == "MESH":
        mat = bpy.data.materials.new(name=f"dancer_{i}")
        mat.diffuse_color = colors[i % len(colors)]
        obj.data.materials.append(mat)

bpy.ops.wm.save_as_mainfile(filepath=out_blend)
'''


def write_blender_import_script(path: str) -> str:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(_IMPORT_SCRIPT)
    return path


def blender_available() -> bool:
    return shutil.which("blender") is not None


def launch(input_dir: str, output_dir: str, pattern: str = "*.bvh") -> list:
    """Run Blender headless per animation file; returns written .blends."""
    if not blender_available():
        raise RuntimeError(
            "no `blender` binary on PATH; BVH/FBX files are still usable by "
            "importing them into Blender manually"
        )
    os.makedirs(output_dir, exist_ok=True)
    script = write_blender_import_script(os.path.join(output_dir, "_import.py"))
    written = []
    for anim in sorted(glob.glob(os.path.join(input_dir, pattern))):
        out = os.path.join(
            output_dir, os.path.splitext(os.path.basename(anim))[0] + ".blend"
        )
        subprocess.run(
            ["blender", "--background", "--python", script, "--", anim, out],
            check=True,
        )
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="batch Blender import/retarget")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--pattern", default="*.bvh")
    opt = p.parse_args(argv)
    for path in launch(opt.input_dir, opt.output_dir, opt.pattern):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
