"""Audio DSP primitives on numpy/scipy, run on the host.

A copy of `tcdiff_tpu/data/audio.py` (the port imports nothing of that
package). The reference leans on librosa for all music analysis (its
`data/data_preprocess/_preprocess_wav.py:1-83`); these are librosa-compatible
implementations (n_fft=2048, hop=512, center-padded frames, slaney mel
filterbank, type-II orthonormal DCT), enough to reproduce the 438-d feature
recipe end to end. The arithmetic is the JAX package's, so the features
agree bit for bit (tests/test_torch_audio.py).
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np
from scipy import signal as sps
from scipy.fft import dct, rfft, irfft
from scipy.ndimage import median_filter


# --------------------------------------------------------------------- wav IO
def load_wav(path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a wav as mono float32 in [-1, 1], resampling to `sr` if given
    (librosa.load semantics, `dataset_utils.py:63`)."""
    with wave.open(path, "rb") as w:
        nch, sw, fr, nframes = w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()
        raw = w.readframes(nframes)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 3:  # 24-bit PCM: widen to i32 via zero-padded little-endian
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        widened = np.zeros((b.shape[0], 4), dtype=np.uint8)
        widened[:, 1:] = b
        x = widened.view("<i4")[:, 0].astype(np.float32) / 2147483648.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if nch > 1:
        x = x.reshape(-1, nch).mean(axis=1)
    if sr is not None and sr != fr:
        g = np.gcd(int(sr), int(fr))
        x = sps.resample_poly(x, sr // g, fr // g).astype(np.float32)
        fr = sr
    return x, fr


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    x16 = np.clip(np.asarray(x) * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())


# ----------------------------------------------------------------------- STFT
def stft(
    y: np.ndarray, n_fft: int = 2048, hop_length: int = 512, center: bool = True
) -> np.ndarray:
    """Complex STFT, hann window, librosa frame conventions.

    Returns (1 + n_fft//2, n_frames)."""
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect" if len(y) >= n_fft // 2 + 1 else "constant")
    n_frames = 1 + (len(y) - n_fft) // hop_length if len(y) >= n_fft else 0
    if n_frames <= 0:
        return np.zeros((1 + n_fft // 2, 0), dtype=np.complex64)
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = y[idx] * np.hanning(n_fft + 1)[:-1][None, :]
    return rfft(frames, axis=1).T.astype(np.complex64)


def istft(
    S: np.ndarray, n_fft: int = 2048, hop_length: int = 512, length: Optional[int] = None
) -> np.ndarray:
    """Inverse STFT with hann overlap-add + squared-window normalization."""
    win = np.hanning(n_fft + 1)[:-1]
    frames = irfft(S.T, n=n_fft, axis=1) * win[None, :]
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(out_len, dtype=np.float64)
    wsum = np.zeros(out_len, dtype=np.float64)
    for i in range(n_frames):  # overlap-add
        sl = slice(i * hop_length, i * hop_length + n_fft)
        y[sl] += frames[i]
        wsum[sl] += win**2
    y = y / np.maximum(wsum, 1e-10)
    y = y[n_fft // 2 :]  # undo center padding
    if length is not None:
        y = np.pad(y[:length], (0, max(0, length - len(y))))
    return y.astype(np.float32)


# ---------------------------------------------------------------- mel / MFCC
def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mel = np.where(above, (min_log_hz / f_sp) + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_hz / f_sp
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_hz / f_sp)), freqs)
    return freqs


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (librosa.filters.mel)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def melspectrogram(
    y: np.ndarray, sr: int, n_fft: int = 2048, hop_length: int = 512, n_mels: int = 128
) -> np.ndarray:
    S = np.abs(stft(y, n_fft, hop_length)) ** 2
    return mel_filterbank(sr, n_fft, n_mels) @ S


def power_to_db(S: np.ndarray, ref=1.0, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    if callable(ref):
        ref = ref(S)
    mag = np.maximum(amin, S)
    db = 10.0 * np.log10(mag) - 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def mfcc_from_db(S_db: np.ndarray, n_mfcc: int = 20) -> np.ndarray:
    """Type-II orthonormal DCT over mel bands (librosa.feature.mfcc(S=...))."""
    return dct(S_db, type=2, axis=0, norm="ortho")[:n_mfcc]


def delta(x: np.ndarray, width: int = 3, order: int = 1) -> np.ndarray:
    """Savitzky-Golay delta features (librosa.feature.delta defaults)."""
    return sps.savgol_filter(
        x, width, polyorder=min(order, width - 1), deriv=order, axis=-1, mode="interp"
    )


# ----------------------------------------------------------------------- HPSS
def hpss(
    y: np.ndarray, kernel_size: int = 31, power: float = 2.0,
    n_fft: int = 2048, hop_length: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Harmonic/percussive separation by median filtering
    (librosa.effects.hpss / Fitzgerald 2010): harmonic = time-median,
    percussive = frequency-median, soft Wiener masks with exponent `power`."""
    S = stft(y, n_fft, hop_length)
    mag = np.abs(S)
    harm = median_filter(mag, size=(1, kernel_size), mode="reflect")
    perc = median_filter(mag, size=(kernel_size, 1), mode="reflect")
    hp = harm**power
    pp = perc**power
    total = hp + pp
    zero = total < 1e-10
    total[zero] = 1.0
    mask_h = np.where(zero, 0.0, hp / total)
    mask_p = np.where(zero, 0.0, pp / total)
    n = len(y)
    return istft(S * mask_h, n_fft, hop_length, n), istft(S * mask_p, n_fft, hop_length, n)


# --------------------------------------------------------------- chroma (CQT)
def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    return fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)


def pseudo_cqt(
    y: np.ndarray, sr: int, fmin: float = 32.703195662574764,  # C1
    n_bins: int = 84, bins_per_octave: int = 12,
    hop_length: int = 512, n_fft: int = 4096,
) -> np.ndarray:
    """Constant-Q magnitudes approximated from a long STFT: each CQ bin is a
    triangular weighting of FFT bins around its center frequency (the
    pseudo-CQT construction; exact CQT is unnecessary for 12-bin chroma)."""
    mag = np.abs(stft(y, n_fft, hop_length))
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    # triangular filters with constant-Q bandwidths
    fb = np.zeros((n_bins, len(fft_freqs)))
    q_alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    for k, fc in enumerate(freqs):
        bw = max(fc * q_alpha * 2.0, fft_freqs[1] * 2.001)  # at least ~2 FFT bins
        w = 1.0 - np.abs(fft_freqs - fc) / bw
        fb[k] = np.maximum(0, w)
        s = fb[k].sum()
        if s > 0:
            fb[k] /= s
    return fb @ mag


def chroma_cqt(
    y: np.ndarray, sr: int, n_octaves: int = 7, bins_per_octave: int = 36,
    hop_length: int = 512, n_chroma: int = 12,
) -> np.ndarray:
    """12-bin chroma from constant-Q magnitudes, per-frame inf-norm
    normalized (librosa.feature.chroma_cqt semantics on a pseudo-CQT)."""
    n_bins = n_octaves * bins_per_octave
    C = pseudo_cqt(
        y, sr, n_bins=n_bins, bins_per_octave=bins_per_octave, hop_length=hop_length
    )
    # fold CQ bins onto pitch classes
    merge = bins_per_octave // n_chroma
    C = C[: (n_bins // merge) * merge]
    C = C.reshape(-1, merge, C.shape[-1]).sum(axis=1)  # -> n_octaves*12 bins
    chroma = C.reshape(n_octaves, n_chroma, -1).sum(axis=0)
    peak = chroma.max(axis=0, keepdims=True)
    return chroma / np.maximum(peak, 1e-10)


# ----------------------------------------------------- onset / beat / tempo
def onset_strength(
    y: np.ndarray, sr: int, n_fft: int = 2048, hop_length: int = 512,
    n_mels: int = 128, lag: int = 1, aggregate=np.median,
) -> np.ndarray:
    """Spectral-flux onset envelope (librosa.onset.onset_strength with
    aggregate=np.median, `_preprocess_wav.py:61-63`)."""
    S = power_to_db(melspectrogram(y, sr, n_fft, hop_length, n_mels), ref=np.max)
    diff = np.maximum(0.0, S[:, lag:] - S[:, :-lag])
    env = aggregate(diff, axis=0)
    # compensate the STFT center shift like librosa (pad n_fft//(2*hop) frames)
    pad = 1 + n_fft // (2 * hop_length)
    env = np.concatenate([np.zeros(pad), env])
    return env[: S.shape[1]].astype(np.float32)


def tempo_frequencies(win_length: int, sr: int, hop_length: int) -> np.ndarray:
    """BPM of each tempogram lag row (lag 0 -> inf, suppressed to 0)."""
    lags = np.arange(win_length, dtype=np.float64)
    with np.errstate(divide="ignore"):
        bpm = 60.0 * sr / (hop_length * lags)
    bpm[0] = np.inf
    return bpm


def tempogram(
    onset_env: np.ndarray, sr: int, hop_length: int = 512, win_length: int = 384,
) -> np.ndarray:
    """Local autocorrelation tempogram (librosa.feature.tempogram):
    hann-windowed onset frames, per-frame autocorrelation over lags
    [0, win), inf-norm normalized. Returns (win_length, n_frames)."""
    n = len(onset_env)
    pad = win_length // 2
    padded = np.pad(onset_env, pad, mode="linear_ramp", end_values=0)
    # frame: (win_length, n)
    idx = np.arange(win_length)[:, None] + np.arange(n)[None, :]
    frames = padded[idx] * np.hanning(win_length + 1)[:-1][:, None]
    # autocorrelation via FFT along the window axis
    nfft = int(2 ** np.ceil(np.log2(2 * win_length)))
    F = np.fft.rfft(frames, n=nfft, axis=0)
    ac = np.fft.irfft(F * np.conj(F), n=nfft, axis=0)[:win_length]
    peak = np.abs(ac).max(axis=0, keepdims=True)
    return (ac / np.maximum(peak, 1e-10)).astype(np.float32)


def estimate_tempo(
    onset_env: np.ndarray, sr: int, hop_length: int = 512,
    start_bpm: float = 120.0, std_bpm: float = 1.0,
) -> float:
    """Global tempo from the mean tempogram weighted by a log-normal prior
    around start_bpm (librosa.beat.tempo)."""
    tg = tempogram(onset_env, sr, hop_length)
    mean_tg = tg.mean(axis=1)
    bpms = tempo_frequencies(tg.shape[0], sr, hop_length)
    with np.errstate(divide="ignore", invalid="ignore"):
        logprior = -0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2
    logprior[~np.isfinite(logprior)] = -np.inf
    best = int(np.argmax(mean_tg * np.exp(logprior - logprior.max())))
    return float(bpms[best]) if np.isfinite(bpms[best]) else start_bpm


def beat_track(
    onset_env: np.ndarray, sr: int, hop_length: int = 512,
    start_bpm: float = 120.0, tightness: float = 100.0,
) -> Tuple[float, np.ndarray]:
    """Dynamic-programming beat tracker (Ellis 2007, the algorithm behind
    librosa.beat.beat_track): score[i] = env[i] + max_j(score[j] -
    tightness*(log(i-j) - log(period))^2), backtrack from the best tail."""
    if onset_env.max() <= 0:
        return start_bpm, np.zeros(0, dtype=int)
    env = onset_env / onset_env.std(ddof=1) if onset_env.std(ddof=1) > 0 else onset_env
    bpm = estimate_tempo(onset_env, sr, hop_length, start_bpm)
    period = max(1, int(round(60.0 * sr / (bpm * hop_length))))

    n = len(env)
    window = np.arange(-2 * period, -period // 2 + 1)
    txcost = -tightness * (np.log(-window / period) ** 2)
    score = np.zeros(n)
    backlink = -np.ones(n, dtype=int)
    for i in range(n):
        lo = i + window[0]
        cand = window + i
        valid = cand >= 0
        if not valid.any():
            score[i] = env[i]
            continue
        sc = txcost[valid] + score[cand[valid]]
        k = int(np.argmax(sc))
        best = sc[k]
        if best > 0 or i >= period:
            score[i] = env[i] + best
            backlink[i] = cand[valid][k]
        else:
            score[i] = env[i]
    # pick the best final beat among the last period's local maxima
    tail = score[-period:] if n >= period else score
    last = n - len(tail) + int(np.argmax(tail))
    beats = [last]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    return bpm, np.asarray(beats[::-1], dtype=int)
