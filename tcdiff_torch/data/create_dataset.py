"""Offline dataset creation CLI: split -> slice -> extract feats438.

A copy of `tcdiff_tpu/data/create_dataset.py`, on the port's own `audio`
and `features` (numpy/scipy on the host; the same files, bit for bit). It
rebuilds the reference's `data/create_dataset.py:12-26`,
`filter_split_data.py:18-35`, `slice.py:74-117` and
`dancernum_split/get_num_split.py:12-29` without librosa or soundfile.
Usage:

    python -m tcdiff_torch.data.create_dataset --dataset_folder ./AIOZ_Dataset

Raw layout expected (AIOZ-GDance): `motions_smpl/<seq>.pkl` with
`{"root_trans": (dn, T, 3), "smpl_poses": (dn, T, 72), "smpl_betas", "meta"}`
and `musics438/<seq>.wav`; split lists in
`train_split_sequence_names.txt` / `val_split_sequence_names.txt`.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import shutil
from pathlib import Path

import numpy as np

from tcdiff_torch.data.audio import load_wav, save_wav
from tcdiff_torch.data.features import processing_music_list


def file_to_list(path: str):
    with open(path) as f:
        return [x.strip() for x in f if x.strip()]


def split_data(dataset_path: str, out_root: str | None = None) -> None:
    """Repackage raw motions + copy wavs into train/ and test/ subtrees
    (`filter_split_data.py:18-35`)."""
    out_root = out_root or dataset_path
    train_list = file_to_list(os.path.join(dataset_path, "train_split_sequence_names.txt"))
    test_list = file_to_list(os.path.join(dataset_path, "val_split_sequence_names.txt"))
    for split_list, split_name in ((train_list, "train"), (test_list, "test")):
        mdir = Path(out_root) / split_name / "motions"
        wdir = Path(out_root) / split_name / "wavs"
        mdir.mkdir(parents=True, exist_ok=True)
        wdir.mkdir(parents=True, exist_ok=True)
        for seq in split_list:
            motion = os.path.join(dataset_path, "motions_smpl", f"{seq}.pkl")
            wav = os.path.join(dataset_path, "musics438", f"{seq}.wav")
            for path in (motion, wav):
                if not os.path.isfile(path):
                    raise FileNotFoundError(path)
            with open(motion, "rb") as f:
                md = pickle.load(f)
            out = {
                "pos": md["root_trans"],
                "q": md["smpl_poses"],
                "betas": md.get("smpl_betas"),
                "meta": md.get("meta"),
            }
            with open(mdir / f"{seq}.pkl", "wb") as f:
                pickle.dump(out, f)
            shutil.copyfile(wav, wdir / f"{seq}.wav")


def slice_audio(audio_file: str, stride: float, length: float, out_dir: str) -> int:
    """5 s windows, 0.5 s stride (`slice.py:10-26`). Returns slice count.

    Unlike the reference (which swallows every exception with a bare
    try/except), IO errors surface: silent data loss is a bug."""
    audio, sr = load_wav(audio_file)
    name = os.path.splitext(os.path.basename(audio_file))[0]
    window = int(length * sr)
    stride_step = int(stride * sr)
    idx = 0
    for start in range(0, len(audio) - window + 1, stride_step):
        save_wav(f"{out_dir}/{name}_slice{idx}.wav", audio[start : start + window], sr)
        idx += 1
    return idx


def slice_aioz_motion(
    motion_file: str, stride: float, length: float, num_slices: int, out_dir: str,
    fps: int = 30,
) -> int:
    """Slice (dn, T, .) motion arrays to match audio slices (`slice.py:74-94`)."""
    with open(motion_file, "rb") as f:
        motion = pickle.load(f)
    pos, q = np.asarray(motion["pos"]), np.asarray(motion["q"])
    name = os.path.splitext(os.path.basename(motion_file))[0]
    window = int(length * fps)
    stride_step = int(stride * fps)
    count = 0
    start = 0
    while start <= pos.shape[1] - window and count < num_slices:
        out = {"pos": pos[:, start : start + window], "q": q[:, start : start + window]}
        with open(f"{out_dir}/{name}_slice{count}.pkl", "wb") as f:
            pickle.dump(out, f)
        start += stride_step
        count += 1
    return count


def slice_aioz(motion_dir: str, wav_dir: str, stride: float = 0.5, length: float = 5.0) -> None:
    """Slice every paired (motion, wav) sequence (`slice.py:96-117`)."""
    wavs = sorted(glob.glob(f"{wav_dir}/*.wav"))
    motions = sorted(glob.glob(f"{motion_dir}/*.pkl"))
    wav_out = wav_dir + "_sliced"
    motion_out = motion_dir + "_sliced"
    os.makedirs(wav_out, exist_ok=True)
    os.makedirs(motion_out, exist_ok=True)
    if len(wavs) != len(motions):
        raise ValueError(f"{len(wavs)} wavs in {wav_dir} but {len(motions)} motions in {motion_dir}")
    for wav, motion in zip(wavs, motions):
        m_name = os.path.splitext(os.path.basename(motion))[0]
        w_name = os.path.splitext(os.path.basename(wav))[0]
        if m_name != w_name:
            raise ValueError(f"unpaired motion and wav: {motion}, {wav}")
        if os.path.exists(f"{wav_out}/{m_name}_slice0.wav"):
            continue
        n_audio = slice_audio(wav, stride, length, wav_out)
        slice_aioz_motion(motion, stride, length, n_audio, motion_out)


def slice_audio_folder(wav_dir: str, stride: float = 0.5, length: float = 5.0) -> None:
    """Slice a folder of wavs WITHOUT paired motions, for out-of-dataset
    music (`slice.py`'s `slice_audio_folder`); feeds the test and generate
    modes."""
    out = wav_dir + "_sliced"
    os.makedirs(out, exist_ok=True)
    for wav in sorted(glob.glob(f"{wav_dir}/*.wav")):
        name = os.path.splitext(os.path.basename(wav))[0]
        if os.path.exists(f"{out}/{name}_slice0.wav"):
            continue
        slice_audio(wav, stride, length, out)


def generate_dancer_split(
    motion_dir: str, save_path: str, required_dancer_num: int
) -> str:
    """Write split_dancerNum_<n>.txt listing sequences with exactly n dancers
    (`dancernum_split/get_num_split.py:12-29`)."""
    os.makedirs(save_path, exist_ok=True)
    names = []
    for motion_file in sorted(glob.glob(os.path.join(motion_dir, "*.pkl"))):
        with open(motion_file, "rb") as f:
            motion = pickle.load(f)
        trans = np.asarray(motion["root_trans" if "root_trans" in motion else "pos"])
        if trans.shape[0] == required_dancer_num:
            names.append(os.path.splitext(os.path.basename(motion_file))[0])
    out = os.path.join(save_path, f"split_dancerNum_{required_dancer_num}.txt")
    with open(out, "w") as f:
        f.writelines(n + "\n" for n in names)
    return out


def create_dataset(opt) -> None:
    """split -> slice -> feats438 (`create_dataset.py:12-26`)."""
    print("Creating train / test split")
    split_data(opt.dataset_folder, opt.root_path)
    for split in ("train", "test"):
        print(f"Slicing {split} data")
        slice_aioz(
            os.path.join(opt.root_path, split, "motions"),
            os.path.join(opt.root_path, split, "wavs"),
            stride=opt.stride, length=opt.length,
        )
        print(f"Extracting {split} features")
        processing_music_list(
            os.path.join(opt.root_path, split, "wavs_sliced"), opt.root_path, split,
            workers=getattr(opt, "workers", None),
        )


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stride", type=float, default=0.5)
    p.add_argument("--length", type=float, default=5.0)
    p.add_argument("--dataset_folder", type=str, default="./AIOZ_Dataset")
    p.add_argument("--root-path", dest="root_path", type=str, default="./AIOZ_Dataset")
    p.add_argument("--workers", type=int, default=None,
                   help="feature-extraction processes (default: 3/4 of CPUs)")
    return p.parse_args(argv)


if __name__ == "__main__":
    create_dataset(parse_opt())
