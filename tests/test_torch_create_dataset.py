"""The port's offline pipeline (split -> slice -> feats438) against the JAX
package's, on one tiny raw tree: the file layout, the slice counts, the
dancer split and the split-file filter, and the feats438 files equal bit
for bit to the JAX package's on a copy of the same tree. The port extracts
its features through the spawned process pool (2 workers), the JAX
package's one file at a time; a worker imports the features module, which
imports no torch.
"""

import glob
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tcdiff_tpu.data.create_dataset import create_dataset as jax_create_dataset  # noqa: E402
from tcdiff_tpu.data.create_dataset import parse_opt as jax_parse_opt  # noqa: E402
from tcdiff_torch.data.audio import save_wav  # noqa: E402
from tcdiff_torch.data.create_dataset import (  # noqa: E402
    create_dataset, generate_dancer_split, parse_opt, slice_audio, slice_audio_folder,
)
from tcdiff_torch.data.dataset import AIOZDataset, load_split_file  # noqa: E402
from tcdiff_torch.data.features import SR  # noqa: E402
from tcdiff_torch.trajdecoder.dataset import TrajDataset  # noqa: E402

from _torch_data import write_raw_tree  # noqa: E402

NAMES = ("seq000", "seq001", "seq002")  # two train sequences, one test


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(the port's tree, the JAX package's tree): one raw tree, copied."""
    base = tmp_path_factory.mktemp("aioz_cd")
    mine, theirs = base / "torch", base / "jax"
    write_raw_tree(mine, NAMES[:2], NAMES[2:], dn=2, secs=5.5, seed=3, dancers={"seq001": 3})
    shutil.copytree(mine, theirs)
    opt = parse_opt(["--dataset_folder", str(mine), "--root-path", str(mine), "--workers", "2"])
    create_dataset(opt)
    jax_create_dataset(jax_parse_opt(["--dataset_folder", str(theirs), "--root-path", str(theirs),
                                      "--workers", "1"]))
    return mine, theirs


def _files(root, split, sub, ext):
    return sorted(glob.glob(str(root / split / sub / f"*.{ext}")))


def test_pipeline_file_layout(trees):
    root, _ = trees
    for split, n_slices in (("train", 4), ("test", 2)):  # 5.5 s at 0.5 s stride: 2 slices of 5 s
        motions = _files(root, split, "motions_sliced", "pkl")
        assert len(motions) == len(_files(root, split, "wavs_sliced", "wav")) == n_slices
        assert len(_files(root, split, "feats438", "npy")) == n_slices
        with open(motions[0], "rb") as f:
            m = pickle.load(f)
        assert m["pos"].shape == (2, 150, 3) and m["q"].shape == (2, 150, 72)
    feat = np.load(_files(root, "train", "feats438", "npy")[0])
    assert feat.shape == (301, 438) and np.isfinite(feat).all()


def test_files_equal_the_jax_pipeline(trees):
    mine, theirs = trees
    for split in ("train", "test"):
        for sub, ext in (("feats438", "npy"), ("motions_sliced", "pkl"), ("wavs_sliced", "wav")):
            a, b = _files(mine, split, sub, ext), _files(theirs, split, sub, ext)
            assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
            for pa, pb in zip(a, b):
                if ext == "npy":
                    np.testing.assert_array_equal(np.load(pa), np.load(pb))
                elif ext == "pkl":
                    with open(pa, "rb") as fa, open(pb, "rb") as fb:
                        da, db = pickle.load(fa), pickle.load(fb)
                    for k in ("pos", "q"):
                        np.testing.assert_array_equal(da[k], db[k])
                else:
                    assert open(pa, "rb").read() == open(pb, "rb").read()


def test_dancer_split_and_split_file_filter(trees, tmp_path):
    root, _ = trees
    two = load_split_file(generate_dancer_split(str(root / "motions_smpl"), str(tmp_path), 2))
    three = load_split_file(generate_dancer_split(str(root / "motions_smpl"), str(tmp_path), 3))
    assert two == ["seq000", "seq002"] and three == ["seq001"]
    ds = AIOZDataset(str(root), train=True, required_dancer_num=2, split_file=two, device="cpu")
    assert len(ds) == 2 and all("seq000_slice" in f for f in ds.feature_files)
    ds3 = AIOZDataset(str(root), train=True, required_dancer_num=3, device="cpu")  # the dancer filter
    assert len(ds3) == 2 and all("seq001_slice" in f for f in ds3.feature_files)
    assert TrajDataset(str(root), train=True, required_dancer_num=2, device="cpu").roots.shape == (2, 2, 150, 3)


def test_slice_audio_counts(tmp_path):
    save_wav(str(tmp_path / "a.wav"), np.zeros(int(7.2 * SR), np.float32), SR)
    assert slice_audio(str(tmp_path / "a.wav"), 0.5, 5.0, str(tmp_path)) == 5  # starts 0, 0.5, ..., 2.0


def test_slice_audio_folder(tmp_path):
    wav_dir = tmp_path / "ood"
    wav_dir.mkdir()
    save_wav(str(wav_dir / "song.wav"), np.zeros(int(6.0 * SR), np.float32), SR)
    slice_audio_folder(str(wav_dir))
    assert len(glob.glob(str(tmp_path / "ood_sliced" / "*.wav"))) == 3  # starts 0, 0.5, 1.0
    slice_audio_folder(str(wav_dir))  # idempotent
    assert len(glob.glob(str(tmp_path / "ood_sliced" / "*.wav"))) == 3


def test_feature_workers_import_no_torch():
    code = "import sys, tcdiff_torch.data.features; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"
