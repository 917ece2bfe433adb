"""pkl -> FBX conversion (Autodesk FBX SDK, optional).

A copy of `tcdiff_tpu/export/fbx_export.py`, the surface of the
reference's `Blender_Visulization/2-ConvertPkl2FBX_SMPL.py` +
`src/FbxReadWriter.py:19-147` + `src/SmplObject.py:9-113`: write SMPL
axis-angle animation curves onto a template rig. The FBX Python SDK is a
proprietary wheel that is rarely installed: `fbx_available()` gates it, and
`tcdiff_torch.export.bvh` is the dependency-free path into Blender.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Dict, Iterator, Tuple

import numpy as np

# the reference rig's bone naming (`src/SmplObject.py:10-35`)
SMPL_FBX_JOINTS = [
    "m_avg_Pelvis", "m_avg_L_Hip", "m_avg_R_Hip", "m_avg_Spine1",
    "m_avg_L_Knee", "m_avg_R_Knee", "m_avg_Spine2", "m_avg_L_Ankle",
    "m_avg_R_Ankle", "m_avg_Spine3", "m_avg_L_Foot", "m_avg_R_Foot",
    "m_avg_Neck", "m_avg_L_Collar", "m_avg_R_Collar", "m_avg_Head",
    "m_avg_L_Shoulder", "m_avg_R_Shoulder", "m_avg_L_Elbow", "m_avg_R_Elbow",
    "m_avg_L_Wrist", "m_avg_R_Wrist", "m_avg_L_Hand", "m_avg_R_Hand",
]


def fbx_available() -> bool:
    try:
        import fbx  # noqa: F401

        return True
    except ImportError:
        return False


class SmplObjects:
    """Iterate per-dancer pkls as {name: {"smpl_poses", "smpl_trans"}}
    (`src/SmplObject.py:37-113`)."""

    joints = SMPL_FBX_JOINTS

    def __init__(self, read_path: str):
        self.files: Dict[str, Dict[str, np.ndarray]] = {}
        for path in sorted(glob.glob(os.path.join(read_path, "*.pkl"))):
            with open(path, "rb") as f:
                data = pickle.load(f)
            self.files[os.path.basename(path)] = {
                "smpl_poses": np.asarray(data["smpl_poses"]),
                "smpl_trans": np.asarray(data["smpl_trans"]),
            }
        self.keys = sorted(self.files.keys())

    def __len__(self) -> int:
        return len(self.keys)

    def __iter__(self) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
        for k in self.keys:
            yield k, self.files[k]


def pkl_to_fbx(pkl_path: str, template_fbx: str, out_path: str, fps: float = 30.0) -> str:
    """Write animation curves from one pkl onto the template rig.

    Requires the FBX SDK; raises ImportError with the BVH alternative
    otherwise.
    """
    if not fbx_available():
        raise ImportError(
            "the Autodesk FBX Python SDK is not installed; use "
            "tcdiff_torch.export.bvh.pkl_to_bvh for a dependency-free path"
        )
    import fbx
    import FbxCommon

    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    poses = np.asarray(data["smpl_poses"]).reshape(-1, 24, 3)
    trans = np.asarray(data["smpl_trans"])

    manager, scene = FbxCommon.InitializeSdkObjects()
    ok = FbxCommon.LoadScene(manager, scene, template_fbx)
    if not ok:
        raise RuntimeError(f"failed to load template {template_fbx}")

    stack = scene.GetCurrentAnimationStack()
    layer = stack.GetMember(0)
    time_mode = fbx.FbxTime()

    def node_by_name(name):
        root = scene.GetRootNode()

        def walk(n):
            if n.GetName() == name:
                return n
            for i in range(n.GetChildCount()):
                r = walk(n.GetChild(i))
                if r is not None:
                    return r
            return None

        return walk(root)

    # root translation curves on the pelvis node (`FbxReadWriter.py:58-87`)
    pelvis = node_by_name(SMPL_FBX_JOINTS[0])
    for axis_i, axis in enumerate("XYZ"):
        curve = pelvis.LclTranslation.GetCurve(layer, axis, True)
        curve.KeyModifyBegin()
        for t in range(len(trans)):
            time_mode.SetSecondDouble(t / fps)
            k = curve.KeyAdd(time_mode)[0]
            curve.KeySetValue(k, float(trans[t, axis_i] * 100.0))
            curve.KeySetInterpolation(k, fbx.FbxAnimCurveDef.eInterpolationCubic)
        curve.KeyModifyEnd()

    # per-joint euler rotation curves (`FbxReadWriter.py:89-131`)
    from tcdiff_torch.export.bvh import _axis_angle_to_euler_zxy_deg

    euler = _axis_angle_to_euler_zxy_deg(poses)  # (T, 24, 3) as (Z, X, Y)
    for j, name in enumerate(SMPL_FBX_JOINTS):
        node = node_by_name(name)
        if node is None:
            continue
        for curve_axis, comp in (("X", 1), ("Y", 2), ("Z", 0)):
            curve = node.LclRotation.GetCurve(layer, curve_axis, True)
            curve.KeyModifyBegin()
            for t in range(len(euler)):
                time_mode.SetSecondDouble(t / fps)
                k = curve.KeyAdd(time_mode)[0]
                curve.KeySetValue(k, float(euler[t, j, comp]))
                curve.KeySetInterpolation(k, fbx.FbxAnimCurveDef.eInterpolationCubic)
            curve.KeyModifyEnd()

    FbxCommon.SaveScene(manager, scene, out_path)
    manager.Destroy()
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="convert per-dancer pkls to FBX")
    p.add_argument("--input_pkl_base", required=True)
    p.add_argument("--fbx_source_path", required=True, help="template SMPL rig fbx")
    p.add_argument("--output_base", required=True)
    opt = p.parse_args(argv)
    smpl = SmplObjects(opt.input_pkl_base)
    os.makedirs(opt.output_base, exist_ok=True)
    for name, _ in smpl:
        out = os.path.join(opt.output_base, os.path.splitext(name)[0] + ".fbx")
        pkl_to_fbx(os.path.join(opt.input_pkl_base, name), opt.fbx_source_path, out)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
