"""The 438-d music feature recipe @ 60 FPS, on the host (numpy/scipy).

A copy of `tcdiff_tpu/data/features.py`, which rebuilds the
reference's `data/data_preprocess/_preprocess_wav.py:5-83` and
`dataset_utils.py:45-86` without librosa:

    MFCC(20) + dMFCC(20) + chroma-CQT(12, harmonic) + onset envelope(1,
    percussive, median-aggregated) + beat one-hot(1) + tempogram(384)
    = 438 channels, SR = 60 FPS * 512 hop = 30720 Hz.

Feature rows are transposed to (frames, 438), the layout of the reference's
saved .npy files. Feature extraction stays on the host by design, as in the
JAX package; the arrays go to the card afterwards. `processing_music_list`
fans the files of a directory out over a spawned process pool; each child
imports this module afresh, which imports neither torch nor CUDA.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from tcdiff_torch.data import audio as A

FPS = 60
HOP_LENGTH = 512
SR = FPS * HOP_LENGTH  # 30720


def extract_music_features(y: np.ndarray, sr: int = SR) -> np.ndarray:
    """Mono waveform @ 30720 Hz -> (n_frames, 438) float32."""
    melspe_db = A.power_to_db(A.melspectrogram(y, sr, hop_length=HOP_LENGTH), ref=np.max)
    mfcc = A.mfcc_from_db(melspe_db, n_mfcc=20)
    mfcc_delta = A.delta(mfcc, width=3)

    harmonic, percussive = A.hpss(y, hop_length=HOP_LENGTH)
    chroma = A.chroma_cqt(harmonic, sr, n_octaves=7, hop_length=HOP_LENGTH)

    onset_env = A.onset_strength(percussive, sr, hop_length=HOP_LENGTH)
    tempo_gram = A.tempogram(onset_env, sr, hop_length=HOP_LENGTH)

    _, beats = A.beat_track(onset_env, sr, hop_length=HOP_LENGTH)
    beat_one_hot = np.zeros(len(onset_env), dtype=np.float32)
    beat_one_hot[beats[beats < len(beat_one_hot)]] = 1.0

    n = min(
        mfcc.shape[1], mfcc_delta.shape[1], chroma.shape[1],
        len(onset_env), len(beat_one_hot), tempo_gram.shape[1],
    )
    feature = np.concatenate(
        [
            mfcc[:, :n],               # 20
            mfcc_delta[:, :n],         # 20
            chroma[:, :n],             # 12
            onset_env[None, :n],       # 1
            beat_one_hot[None, :n],    # 1
            tempo_gram[:, :n],         # 384
        ],
        axis=0,
    )
    # C-contiguous, so that np.save does not record fortran_order
    return np.ascontiguousarray(feature.T, dtype=np.float32)  # (frames, 438)


def wav_processing(wav_path: str, save_npy: bool = False) -> np.ndarray:
    """Extract features from a wav file (reference `dataset_utils.py:45-86`)."""
    y, _ = A.load_wav(wav_path, sr=SR)
    feat = extract_music_features(y)
    if save_npy:
        np.save(os.path.splitext(wav_path)[0] + ".npy", feat)
    return feat


def _extract_one(args) -> str:
    """(wav path, feats438 path): extract and save. At module level, so that
    a spawned worker can import it."""
    src_wav, feat_npy = args
    np.save(feat_npy, wav_processing(src_wav))
    return feat_npy


def processing_music_list(music_data_path: str, root_path: str, folder_state: str, verbose: bool = True,
                          workers: Optional[int] = None) -> None:
    """Extract a feats438 .npy for every wav of a directory into
    `{root_path}/{folder_state}/feats438` (`dataset_utils.py:12-43`),
    skipping files already there; a precomputed `<name>.npy` beside a wav
    is copied as it is. The files fan out over `workers` processes
    (default: 3/4 of the CPUs); the reference runs its librosa chain file by
    file."""
    feats_path = Path(root_path) / folder_state / "feats438"
    feats_path.mkdir(parents=True, exist_ok=True)

    todo = []
    names = sorted({os.path.splitext(f)[0] for f in os.listdir(music_data_path)})
    for name in names:
        feat_npy = feats_path / f"{name}.npy"
        src_npy = Path(music_data_path) / f"{name}.npy"
        src_wav = Path(music_data_path) / f"{name}.wav"
        if feat_npy.exists():
            continue
        if src_npy.exists():
            np.save(feat_npy, np.load(src_npy))
        elif src_wav.exists():
            todo.append((str(src_wav), str(feat_npy)))

    if not todo:
        return
    if workers is None:
        workers = min(len(todo), max(1, (os.cpu_count() or 4) * 3 // 4))
    if workers <= 1 or len(todo) == 1:
        for args in todo:
            if verbose:
                print(f"feats438 <- {args[0]}")
            _extract_one(args)
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(workers) as pool:
        for done in pool.imap_unordered(_extract_one, todo):
            if verbose:
                print(f"feats438 -> {done}")
