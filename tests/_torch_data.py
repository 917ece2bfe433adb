"""Shared set-up of the data-path tests of the port (test_torch_dataset.py,
test_torch_create_dataset.py, test_torch_train_loop.py): a seeded raw tree
in the AIOZ-GDance layout, as `tests/test_e2e_files.py:30` writes one.

`motions_smpl/<seq>.pkl` holds {"root_trans" (dn, T, 3), "smpl_poses" (dn,
T, 72), "smpl_betas", "meta"} at 30 fps, Y-up, smooth (the synthetic
motion's draws, so that some feet are in contact); `musics438/<seq>.wav`
a 220 Hz tone over noise with clicks every 0.5 s at the feature rate; the
split lists name the train and test sequences. A 5.5 s sequence gives 2
slices of 5 s at 0.5 s stride, 6 s gives 3.
"""

import pickle

import numpy as np

from tcdiff_torch.data.audio import save_wav
from tcdiff_torch.data.features import SR
from tcdiff_torch.data.synthetic import synthetic_motion


def write_raw_tree(root, seqs_train, seqs_test, dn=3, secs=5.5, seed=0, dancers=None):
    """Write the raw tree under `root`; `dancers` maps a sequence to another
    dancer count than `dn`."""
    rng = np.random.default_rng(seed)
    (root / "motions_smpl").mkdir(parents=True)
    (root / "musics438").mkdir()
    frames = int(round(secs * 30))
    for i, name in enumerate((*seqs_train, *seqs_test)):
        n_dn = (dancers or {}).get(name, dn)
        pos, q = synthetic_motion(1, n_dn, frames, seed=seed + i)
        md = {"root_trans": pos[0], "smpl_poses": q[0], "smpl_betas": np.zeros((n_dn, 10), np.float32),
              "meta": {"name": name}}
        with open(root / "motions_smpl" / f"{name}.pkl", "wb") as f:
            pickle.dump(md, f)
        t = np.arange(int(secs * SR)) / SR
        y = 0.2 * np.sin(2 * np.pi * 220.0 * t) + 0.02 * rng.normal(size=t.shape)
        y[::SR // 2] = 0.9
        save_wav(str(root / "musics438" / f"{name}.wav"), y.astype(np.float32), SR)
    (root / "train_split_sequence_names.txt").write_text("\n".join(seqs_train) + "\n")
    (root / "val_split_sequence_names.txt").write_text("\n".join(seqs_test) + "\n")
