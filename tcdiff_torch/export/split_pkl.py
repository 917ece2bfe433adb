"""Split multi-dancer FK pkls into per-dancer pkls for the Blender pipeline.

A copy of `tcdiff_tpu/export/split_pkl.py` (after the reference's
`Blender_Visulization/1-preProcess_group_smpl.py:6-46`): reads the
`{"smpl_poses": (dn*T, 72), "smpl_trans": (dn*T, 3), "full_pose": (dn, T,
24, 3)}` files that `tcdiff_torch.viz.postprocess.render_sample(fk_out=...)`
writes and writes `<dir>/<stem>/<i>.pkl` a dancer.

    python -m tcdiff_torch.export.split_pkl --input_dir <dir of pkls>
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import List

import numpy as np


def split_pkl_file(file_path: str, output_prefix: str, name: str) -> List[str]:
    """Write one pkl a dancer under `{output_prefix}/{stem of name}/`;
    returns their paths."""
    with open(file_path, "rb") as f:
        data = pickle.load(f)
    dancer_num, seq_len = data["full_pose"].shape[:2]
    # flat (seq*dn, C) arrays are time-major: frame t holds dancers d0..dn-1
    poses = np.asarray(data["smpl_poses"]).reshape(seq_len, dancer_num, -1)
    trans = np.asarray(data["smpl_trans"]).reshape(seq_len, dancer_num, -1)

    out_dir = os.path.join(output_prefix, os.path.splitext(name)[0])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in range(dancer_num):
        sub = {
            "smpl_poses": poses[:, i, :],
            "smpl_trans": trans[:, i, :],
            "full_pose": data["full_pose"][i : i + 1],
        }
        path = os.path.join(out_dir, f"{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(sub, f)
        written.append(path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="split multi-dancer FK pkls")
    p.add_argument("--input_dir", required=True)
    opt = p.parse_args(argv)
    files = glob.glob(os.path.join(opt.input_dir, "*.pkl"))
    if not files:
        print(f"No PKL files found in directory: {opt.input_dir}")
        return
    for path in files:
        split_pkl_file(path, opt.input_dir, os.path.basename(path))
    print("File splitting completed!")


if __name__ == "__main__":
    main()
