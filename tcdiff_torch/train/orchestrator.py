"""The serving core of the reference's `TCDiff` class: music in, dance out.

Module-level functions named after the JAX package's `TCDiff` methods
(`tcdiff_tpu/train/orchestrator.py`):

  * `window_starts` (`:724-759`) slices the 438-d features into 301-frame
    windows at 2.5 s stride, edge-padding audio shorter than one window;
  * `truncate_motion` (`:761-767`);
  * `make_dbn_traj_fn` (`:656-688`): the DBN trajectory stage of the
    dataset loops, seeded on ground-truth frames;
  * `generate` (`:769-837`, `--mode generate`): features on the host, the
    DBN rolled over the whole song from a circle formation, the Kalman
    filter, then the trajectory-clamped long-form DDIM over every slice;
  * `generate_streaming` (`:839-936`): slices one at a time, each
    inpainting its first half-window from the previous slice's tail, the
    trajectory rolled only as far as the next slice needs.

Both entry points return the normalized samples; rendering and the files
it writes are not part of this module. The denoiser, the DBN and the
normalizer must live on one device (the card unless the caller built them
on the CPU); the features are extracted on the host, by design.

Training, beside them:

  * `load_datasets` (`:250-303`): the synthetic stand-in, or the AIOZ
    train and test splits from disk through the processed-data cache,
    keyed by the dancer count and the sha1 of the split;
  * `train_loop` (`:306-474`): epochs of train steps (`make_train_step`:
    the loss through the train kernels K3/K4/K5, backward, Adan, EMA) over
    the dataset's batches, read by the native prefetcher where the data
    are files; a non-finite loss writes a rescue checkpoint and raises;
    every `save_interval` epochs the metrics (with `StepTimer`'s rates) are
    logged and a checkpoint written. The JAX package's `scan_steps` (TPU
    dispatch machinery), its render and eval during training and its
    host-0 gating are not here.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tcdiff_torch.config import DATA_FPS
from tcdiff_torch.data.dataset import AIOZDataset, load_split_file
from tcdiff_torch.data.features import wav_processing
from tcdiff_torch.data.native_loader import PrefetchingBatches, native_available
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.data.synthetic import synthetic_dataset
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.trajdecoder.kalman import kalman_smooth_batch
from tcdiff_torch.trajdecoder.model import TrajDecoder
from tcdiff_torch.trajdecoder.rollout import autoregressive_rollout
from tcdiff_torch.trajdecoder.rollout import rollout_starts
from tcdiff_torch.trajdecoder.streaming import TrajectoryStreamer
from tcdiff_torch.train.state import TrainState
from tcdiff_torch.utils.checkpoint import save_checkpoint
from tcdiff_torch.utils.logging import MetricLogger
from tcdiff_torch.utils.profiling import StepTimer, trace

log = logging.getLogger(__name__)


def window_starts(feats: np.ndarray, seq: int, name: str = "<features>"):
    """Starts of the 301-frame (2 seq + 1) windows of `feats` (F, 438) at
    `seq`-frame (2.5 s) stride. Returns (feats, starts, true_motion): audio
    shorter than one window is edge-padded to one (true_motion, the motion
    frames the audio covers, then truncates the sample); audio past the
    last full window is dropped, with a warning."""
    win_f, stride_f = 2 * seq + 1, seq
    if feats.shape[0] < 2:
        raise ValueError(f"{name}: audio too short to extract any features")
    true_motion = feats.shape[0] // 2  # music runs at 2x motion FPS
    starts = list(range(0, feats.shape[0] - win_f + 1, stride_f))
    if not starts:
        log.warning("%s: audio (%d feature frames) shorter than one 5 s window; edge-padding and "
                    "truncating the motion to %d frames", name, feats.shape[0], true_motion)
        feats = np.concatenate([feats, np.repeat(feats[-1:], win_f - feats.shape[0], axis=0)])
        return feats, [0], true_motion
    covered = (len(starts) - 1) * (seq // 2) + seq
    if true_motion > covered:
        log.warning("%s: dropping %d trailing motion frames (%.2f s) past the last full window "
                    "(%d of %d frames covered)", name, true_motion - covered, (true_motion - covered) / 30.0,
                    covered, true_motion)
    return feats, starts, covered


def truncate_motion(flat: torch.Tensor, seq: int, dn: int, m: int) -> torch.Tensor:
    """(b, seq*dn, C) time-major tokens -> the first m motion frames."""
    if m >= seq:
        return flat
    b, _, c = flat.shape
    return flat.reshape(b, seq, dn, c)[:, :m].reshape(b, m * dn, c)


def _xy_x0(traj: torch.Tensor) -> torch.Tensor:
    """(b, dn, S, 2) trajectory -> the sampler's x_0 (b, S*dn, 3): XY in
    time-major token order, a zero z."""
    b, dn, s, _ = traj.shape
    xy = traj.permute(0, 2, 1, 3).reshape(b, s * dn, 2)
    return torch.cat([xy, torch.zeros_like(xy[..., :1])], dim=-1)


def _hold_last(traj: torch.Tensor, length: int) -> torch.Tensor:
    """Pad (..., T, 2) along T to `length` with its last frame."""
    if traj.shape[-2] >= length:
        return traj
    return torch.cat([traj, traj[..., -1:, :].expand(*traj.shape[:-2], length - traj.shape[-2], 2)], dim=-2)


def make_dbn_traj_fn(traj_model: TrajDecoder) -> Callable:
    """The DBN trajectory stage of the two-stage pipeline (reference
    `TCDiff.py:503-553`): a function (x, cond) -> x_0 that seeds on the
    first `window_size` frames of x's XY channels (4, 5), rolls the DBN out
    over cond, filters, and packs the XY (and a zero z) in the sampler's
    x_0 layout. x: (b, dn, S, 151) normalized; cond: (b, L, 438)."""
    tcfg, dev = traj_model.cfg, traj_model.device

    @torch.no_grad()
    def dbn_traj(x, cond):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        cond = torch.as_tensor(cond, dtype=torch.float32, device=dev)
        traj = autoregressive_rollout(traj_model, x[:, :, :tcfg.window_size, 4:6], cond, tcfg.window_size,
                                      tcfg.step)
        s = x.shape[2]  # held when the music is too short for the clip, then clamped to it
        return _xy_x0(_hold_last(kalman_smooth_batch(traj), s)[:, :, :s])

    return dbn_traj


def circle_seed(normalizer: Normalizer, dn: int, window_size: int) -> np.ndarray:
    """The default formation: dancers on the unit circle, in NORMALIZED XY
    (channels 4, 5) as the DBN consumes it (reference `TCDiff.py:533`);
    (1, dn, window_size, 2) float32."""
    angles = 2 * np.pi * np.arange(dn) / dn
    world = np.stack([np.cos(angles), np.sin(angles)], -1)  # (dn, 2)
    stats = normalizer.to_numpy()
    seed_xy = np.clip(world * stats["scale"][4:6] + stats["offset"][4:6], -1, 1).astype(np.float32)
    return np.broadcast_to(seed_xy[None, :, None, :], (1, dn, window_size, 2)).copy()


def _check_devices(diffusion: GaussianDiffusion, traj_model: TrajDecoder, normalizer: Normalizer) -> torch.device:
    dev = diffusion.device
    for what, d in (("the DBN", traj_model.device), ("the normalizer", normalizer.device)):
        if d != dev:
            raise ValueError(f"{what} is on {d}, the denoiser on {dev}")
    return dev


class _Clock:
    """Stage times into report["seconds"], the device synchronised at each
    mark; nothing (and no synchronisation) without a report."""

    def __init__(self, report: Optional[dict], dev: torch.device):
        self.report, self.dev = report, dev
        if report is not None:
            report.setdefault("seconds", {})
            self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.report is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        sec = self.report["seconds"]
        sec[stage] = sec.get(stage, 0.0) + now - self.t
        self.t = now


def generate(wav_path: str, diffusion: GaussianDiffusion, traj_model: TrajDecoder, normalizer: Normalizer, *,
             generator: Optional[torch.Generator] = None, noise: Optional[dict] = None,
             report: Optional[dict] = None) -> torch.Tensor:
    """Wav-to-choreography (`--mode generate`) with no dataset on disk:
    features from the wav, then `generate_from_features`. Returns the
    normalized samples (n, seq*dn, nfeats): one row per 5 s slice, the
    slices 2.5 s apart."""
    clock = _Clock(report, diffusion.device)
    feats = wav_processing(wav_path)  # (F, 438) at 60 FPS
    clock.mark("features")
    return generate_from_features(feats, diffusion, traj_model, normalizer, generator=generator, noise=noise,
                                  report=report, name=wav_path)


@torch.no_grad()
def generate_from_features(feats: np.ndarray, diffusion: GaussianDiffusion, traj_model: TrajDecoder,
                           normalizer: Normalizer, *, generator: Optional[torch.Generator] = None,
                           noise: Optional[dict] = None, report: Optional[dict] = None,
                           name: str = "<features>") -> torch.Tensor:
    """The serving path from features (F, 438): windows, the DBN rolled over
    the whole song from the circle formation, the Kalman filter, the last
    frame held out to the frames the slices cover, each slice's trajectory
    at seq//2 stride, then `long_ddim_sample` over the slices (n > 1), or
    `ddim_sample` truncated to the audio's length (one, possibly padded,
    window). `noise`: the sampler's injected noise, as it takes it.
    `report`, where given, receives each stage's seconds (the device
    synchronised between stages), the features as given, the slice and
    window counts, the filtered trajectory (dn, L, 2) and x_0."""
    dev = _check_devices(diffusion, traj_model, normalizer)
    clock = _Clock(report, dev)
    if report is not None:
        report["feats"] = feats
    mcfg, tcfg = diffusion.model.cfg, traj_model.cfg
    seq, dn = mcfg.seq_len, mcfg.dancer_num
    win_f = 2 * seq + 1
    feats, starts, true_motion = window_starts(feats, seq, name)
    n = len(starts)
    cond = torch.from_numpy(np.stack([feats[s:s + win_f] for s in starts])).to(dev)  # (n, 301, 438)

    seed = torch.from_numpy(circle_seed(normalizer, dn, tcfg.window_size)).to(dev)
    music = torch.from_numpy(np.ascontiguousarray(feats[None])).to(dev)
    traj = autoregressive_rollout(traj_model, seed, music, tcfg.window_size, tcfg.step)
    clock.mark("dbn_rollout")
    traj = kalman_smooth_batch(traj)[0]  # (dn, L, 2)
    clock.mark("kalman")

    need = (n - 1) * (seq // 2) + seq  # motion frames the slices cover
    frames = torch.arange(n, device=dev)[:, None] * (seq // 2) + torch.arange(seq, device=dev)
    x_0 = _xy_x0(_hold_last(traj, need)[:, frames].transpose(0, 1))  # (n, seq*dn, 3)

    shape = (n, seq * dn, mcfg.nfeats)
    if n > 1:
        samples = diffusion.long_ddim_sample(shape, cond, generator, x_0=x_0, noise=noise)
    else:  # one window has no neighbour to couple with
        samples = truncate_motion(diffusion.ddim_sample(shape, cond, generator, x_0=x_0, noise=noise),
                                  seq, dn, true_motion)
    clock.mark("sampling")
    if report is not None:
        report.update(slices=n, windows=len(rollout_starts(feats.shape[0], tcfg.window_size, tcfg.step)),
                      traj=traj, x_0=x_0)
    return samples


@torch.no_grad()
def generate_streaming(
        wav_path: str, diffusion: GaussianDiffusion, traj_model: TrajDecoder, normalizer: Normalizer, *,
        generator: Optional[torch.Generator] = None, noise: Optional[Sequence[dict]] = None,
        on_slice: Optional[Callable] = None, resume_from: int = 0, resume_tail: Optional[torch.Tensor] = None,
        slices: Optional[int] = None, report: Optional[dict] = None) -> torch.Tensor:
    """Low-latency wav-to-dance: features from the wav, then the slices one
    at a time, each inpainting its first half-window from the previous
    slice's tail (`ddim_sample_stream`), so the first motion is ready after
    one slice. The DBN trajectory comes from a `TrajectoryStreamer`, rolled
    and filtered only as far as the next slice needs; its frames equal the
    whole song's rollout.

    noise: per-slice injected noise, noise[i] for slice i (as
    `ddim_sample_stream` takes it), or None to draw from `generator`.
    on_slice(i, s4): called with each slice (1, seq, dn, nfeats) as soon as
    it is queued. resume_from=k restarts at slice k from `resume_tail`, the
    (1, half*dn, nfeats) normalized tail of slice k-1; the resumed stream
    equals the uninterrupted one on the same noise. slices: generate at
    most this many (from resume_from); all by default. Returns the motion
    (L, dn, nfeats), normalized: slice resume_from whole (its second half
    only when resumed), then each next slice's second half, truncated to
    the audio's length when the whole song ran. `report` receives the
    seconds of the features, of the trajectory and of the sampling, summed
    over the slices (the device synchronised between them), and the slice
    count."""
    dev = _check_devices(diffusion, traj_model, normalizer)
    clock = _Clock(report, dev)
    feats = wav_processing(wav_path)
    clock.mark("features")
    mcfg, tcfg = diffusion.model.cfg, traj_model.cfg
    seq, dn, c = mcfg.seq_len, mcfg.dancer_num, mcfg.nfeats
    half, win_f = seq // 2, 2 * seq + 1
    feats, starts, true_motion = window_starts(feats, seq, wav_path)
    if resume_from:
        if not 0 < resume_from < len(starts):
            raise ValueError(f"resume_from={resume_from} out of range (1..{len(starts) - 1})")
        if resume_tail is None:
            raise ValueError("resume_from needs resume_tail (the previous slice's tail)")
    todo = list(enumerate(starts))[resume_from:]
    if slices is not None:
        todo = todo[:slices]

    streamer = TrajectoryStreamer(traj_model, circle_seed(normalizer, dn, tcfg.window_size), feats[None],
                                  tcfg.window_size, tcfg.step)
    shape = (1, seq * dn, c)
    pieces = []
    prev_tail = None if not resume_from else torch.as_tensor(resume_tail, dtype=torch.float32, device=dev)
    for i, s in todo:
        x_0 = _xy_x0(streamer.frames(i * half + seq)[:, :, i * half:i * half + seq])
        clock.mark("trajectory")
        cond = torch.from_numpy(feats[s:s + win_f][None]).to(dev)
        sample = diffusion.ddim_sample_stream(shape, cond, generator, x_0=x_0, prev_tail=prev_tail,
                                              noise=None if noise is None else noise[i])
        s4 = sample.reshape(1, seq, dn, c)
        pieces.append(s4[0] if i == 0 else s4[0, half:])
        prev_tail = s4[:, half:].reshape(1, half * dn, c)
        if on_slice is not None:
            on_slice(i, s4)
        clock.mark("sampling")

    full = torch.cat(pieces, dim=0)  # (L, dn, c)
    if not resume_from and full.shape[0] > true_motion:
        full = full[:true_motion]  # padded short audio: drop the padding's motion
    if report is not None:
        report["slices"] = len(todo)
    return full


# ------------------------------------------------------------------ training
class _SyntheticDataset:
    """AIOZDataset-shaped wrapper over synthetic arrays (dataset-free runs)."""

    def __init__(self, n, dancer_num, seed, normalizer=None, seq_len=150, device="cuda"):
        per_sample = normalizer is None
        poses, music, norm = synthetic_dataset(n, dancer_num, seq_len=seq_len, seed=seed,
                                               per_sample_normalization=per_sample, device=device)
        self.poses, self.music = poses, music
        self.normalizer = normalizer if normalizer is not None else norm
        if normalizer is not None:  # as the JAX package does: the fit data normalized once more
            self.poses = normalizer.normalize(torch.from_numpy(poses).to(normalizer.device)).cpu().numpy()
        self.feature_files = [f"synthetic_{i}_slice0.npy" for i in range(n)]
        self.wav_files = [f"synthetic_{i}_slice0.wav" for i in range(n)]

    def __len__(self):
        return len(self.poses)

    def get(self, idx):
        return self.poses[idx], self.music[idx], self.feature_files[idx], self.wav_files[idx]

    def batches(self, batch_size, rng=None, drop_last=True):
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield {"x": self.poses[idx], "cond": self.music[idx],
                   "filename": [self.feature_files[j] for j in idx], "wav": [self.wav_files[j] for j in idx]}


def cache_paths(cache_dir: str, dancer_num: int, split: Optional[Sequence[str]]):
    """The processed-data cache files of the train and test splits: keyed by
    the dancer count and the sha1 of the sorted split, so that another
    --split_file never reads a stale cache."""
    key = hashlib.sha1("\n".join(sorted(split)).encode()).hexdigest()[:8] if split else "all"
    return (os.path.join(cache_dir, f"train_dn{dancer_num}_{key}.npz"),
            os.path.join(cache_dir, f"test_dn{dancer_num}_{key}.npz"))


def load_datasets(opt, dancer_num: int = 3, seq_len: int = 150, seed: int = 0, device="cuda"):
    """(train_ds, test_ds): synthetic with `opt.synthetic`, else the AIOZ
    splits under `opt.data_path` (filtered by `opt.split_file`), read from
    and written to the cache in `opt.processed_data_dir` unless
    `opt.no_cache`; `opt.force_reload` reprocesses (the reference's
    `TCDiff.py:143-173` semantics). The slices are processed on `device`."""
    if getattr(opt, "synthetic", False):
        n = getattr(opt, "synthetic_size", 16)
        train = _SyntheticDataset(n, dancer_num, seed=seed, seq_len=seq_len, device=device)
        test = _SyntheticDataset(max(2, n // 4), dancer_num, seed=seed + 1, normalizer=train.normalizer,
                                 seq_len=seq_len, device=device)
        return train, test
    split = load_split_file(opt.split_file) if getattr(opt, "split_file", None) else None
    cache_dir = getattr(opt, "processed_data_dir", None)
    no_cache = getattr(opt, "no_cache", False)
    tr_cache, te_cache = cache_paths(cache_dir, dancer_num, split) if cache_dir else (None, None)
    if (not no_cache and not getattr(opt, "force_reload", False) and tr_cache
            and os.path.exists(tr_cache) and os.path.exists(te_cache)):
        return AIOZDataset.from_cache(tr_cache, device=device), AIOZDataset.from_cache(te_cache, device=device)
    train = AIOZDataset(opt.data_path, train=True, required_dancer_num=dancer_num, split_file=split, device=device)
    test = AIOZDataset(opt.data_path, train=False, required_dancer_num=dancer_num, split_file=split,
                       normalizer=train.normalizer, device=device)
    if tr_cache and not no_cache:
        train.save_cache(tr_cache)
        test.save_cache(te_cache)
    return train, test


def train_loop(state: TrainState, train_step: Callable, train_ds, run_dir: str, *, epochs: int,
               batch_size: int, save_interval: int, seed: int = 0, profile_dir: Optional[str] = None) -> dict:
    """Train `state` in place for `epochs` epochs of `train_ds`.

    train_step: `make_train_step`'s function for the state's model and
    optimizer. The batches come in an order drawn from numpy's generator
    of `seed`, read by the native prefetcher (`PrefetchingBatches`) where
    the dataset is on disk and a toolchain exists, else by the dataset's
    own `batches`; every draw of the steps comes from one torch.Generator
    of `seed` on the model's device. A non-finite loss writes a
    rescue checkpoint and raises FloatingPointError. Every `save_interval`
    epochs the running means (with steps/s and seconds of motion a second)
    go to `{run_dir}/metrics.jsonl` and a checkpoint to
    `{run_dir}/checkpoints`; `profile_dir` records epoch 2 as a trace.

    Returns {"steps", "loader" ("native" or "numpy"), "checkpoints",
    "metrics" (the last means logged)}."""
    device = next(state.model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    normalizer = train_ds.normalizer
    run_dir = Path(run_dir)
    ckpt_dir = str(run_dir / "checkpoints")
    metrics = MetricLogger(str(run_dir), config={"batch": batch_size, "epochs": epochs})
    data_rng = np.random.default_rng(seed)
    timer = StepTimer()
    motion_s = batch_size * train_ds.poses.shape[2] / DATA_FPS
    use_native = native_available() and not isinstance(train_ds, _SyntheticDataset)
    # the prefetcher reads a fixed number of floats a file (and pads a
    # short file with zeros): take the shape of the dataset's own files
    item_shape = np.load(train_ds.feature_files[0], mmap_mode="r").shape if use_native else None
    out = {"steps": 0, "loader": "native" if use_native else "numpy", "checkpoints": [], "metrics": {}}
    running, n_batches = {}, 0
    try:
        for epoch in range(1, epochs + 1):
            batches = (PrefetchingBatches(train_ds, batch_size, rng=data_rng, item_shape=item_shape) if use_native
                       else train_ds.batches(batch_size, rng=data_rng))
            with trace(profile_dir if epoch == 2 else None):
                for batch in batches:
                    x = torch.as_tensor(batch["x"], dtype=torch.float32).to(device, non_blocking=True)
                    cond = torch.as_tensor(batch["cond"], dtype=torch.float32).to(device, non_blocking=True)
                    timer.tick()
                    state, m = train_step(state, x, cond, generator)
                    total = m["total"].item()  # waits for the card
                    timer.tock()
                    out["steps"] += 1
                    if not np.isfinite(total):
                        # failure detection the reference lacks: halt with a
                        # rescue checkpoint instead of training on NaNs
                        path = save_checkpoint(ckpt_dir, state.step, state, normalizer)
                        out["checkpoints"].append(path)
                        log.error("non-finite loss %s at step %d; rescue checkpoint at %s", total, state.step, path)
                        raise FloatingPointError(f"non-finite loss at step {state.step}")
                    for k, v in m.items():
                        running[k] = running.get(k, 0.0) + float(v)
                    n_batches += 1
            if isinstance(batches, PrefetchingBatches) and batches.loader is not None:
                out["loader"] = batches.loader
            if epoch % save_interval == 0 and n_batches:
                means = {k: v / n_batches for k, v in running.items()}
                means.update(timer.metrics(motion_seconds_per_step=motion_s))
                means["epoch"] = epoch
                metrics.log(means, step=state.step)
                log.info("epoch %d | loss %.4f | %.2f steps/s", epoch, means["total"],
                         means.get("steps_per_sec", float("nan")))
                running, n_batches = {}, 0
                out["metrics"] = means
                out["checkpoints"].append(save_checkpoint(ckpt_dir, state.step, state, normalizer))
    finally:
        metrics.close()
    return out
