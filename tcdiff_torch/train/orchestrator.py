"""The reference's `TCDiff` class: serving, training and the eval loops.

Module-level functions named after the JAX package's `TCDiff` methods
(`tcdiff_tpu/train/orchestrator.py`), the serving core:

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
    logged, a checkpoint written and the caller's `on_save` run. Under
    data parallelism (`mesh`) every rank walks the same seeded batch
    order and reads only its rows of each batch (`Rows`), the halt is
    decided on the loss averaged over the ranks, and only rank 0 logs
    and writes checkpoints (the JAX package's host-0 gating); every rank
    calls the checkpoint's save and `on_save`, since a state split over
    tensor-parallel ranks is gathered first (a collective). The JAX
    package's `scan_steps` (TPU dispatch machinery) is not here.

And the `TCDiff` class (`:131-970`) over them, the five modes of
`cli.train`: `train_loop` (with the render and the metrics at every save
interval), `given_trajectory_generation_loop`, `test_loop`,
`evaluate_loop` and `generate` / `generate_streaming`, each rendering and
writing the FK pkls through `viz/postprocess.py`. It differs from the JAX
package's class in one deliberate way: in training, only the drawing and
the writing of the render are caught; the sampling, the FK and the
metrics run outside the catch, so that a failed kernel launch ends the
run.

Data parallelism: `TCDiff` builds the mesh of `cfg.train.dp`
(`parallel.mesh.make_mesh`; one process a rank, launched by torchrun,
`cli.train` joins the group). The train step all-reduces the gradients;
normal-mode sampling of a batch the ranks divide gives each rank its rows
(the draws made at the global batch) and gathers them (`_sample`); the
other sampler modes run whole on every rank. Only rank 0 logs, writes
checkpoints, renders and evaluates during training, and there it samples
alone (no collective, which the other ranks would never join); in the
other modes every rank runs the loop and only rank 0 writes the files.

Tensor parallelism: `TCDiff` builds the (dp, tp) mesh of `cfg.train.dp`
and `cfg.train.tp` and, with tp > 1, splits its train state over the tp
ranks the JAX package's way (`parallel.sharding_rules.shard_train_state`,
after the build and after a checkpoint's load), so that the train step
runs each layer over this rank's shards. This is the one deliberate
difference from the JAX `TCDiff`, which places a replicated state on its
(dp, tp) mesh, so that there tp peers repeat each other's work: the
numbers are the same (`tests/test_tensor_parallel.py`), but here the tp
peers split the work. Checkpoints are gathered by every rank and written
whole by rank 0. Sampling (every mode, and the train-time render) runs on
a whole serving `DanceDecoder` holding the gathered weights (`sync_weights`,
a collective every rank makes, in training before rank 0 samples alone),
through the serving kernels K1/K2, which take whole-d weights, as in the
JAX package; it is sharded over the dp index, and tp peers repeat each
other, as the JAX package's replicated state does.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tcdiff_torch.config import DATA_FPS, ServingKernels, TCDiffConfig
from tcdiff_torch.data.dataset import AIOZDataset, load_split_file
from tcdiff_torch.data.features import wav_processing
from tcdiff_torch.data.native_loader import PrefetchingBatches, native_available
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.data.synthetic import synthetic_dataset
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.eval.metrics import evaluate
from tcdiff_torch.interop.from_jax import load_reference_traj
from tcdiff_torch.models.dance_decoder import DanceDecoder
from tcdiff_torch.optim.adan import Adan
from tcdiff_torch.parallel.comm import all_gather_rows
from tcdiff_torch.parallel.mesh import Mesh, Rows, make_mesh
from tcdiff_torch.parallel.sharding_rules import gather_train_state, shard_train_state
from tcdiff_torch.trajdecoder.kalman import kalman_smooth_batch
from tcdiff_torch.trajdecoder.model import TrajDecoder
from tcdiff_torch.trajdecoder.rollout import autoregressive_rollout
from tcdiff_torch.trajdecoder.rollout import rollout_starts
from tcdiff_torch.trajdecoder.streaming import TrajectoryStreamer
from tcdiff_torch.train.state import TrainState, create_train_state
from tcdiff_torch.train.train_step import make_train_step
from tcdiff_torch.utils.checkpoint import latest_checkpoint, restore_train_state, save_checkpoint
from tcdiff_torch.utils.logging import MetricLogger, get_logger
from tcdiff_torch.viz.postprocess import fk_sample, postprocess_sample, render_sample, write_sample
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

    def batches(self, batch_size, rng=None, drop_last=True, rows: Optional[Rows] = None):
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            if rows is not None:
                idx = rows.take(idx)
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
               batch_size: int, save_interval: int, seed: int = 0, profile_dir: Optional[str] = None,
               on_save: Optional[Callable[[int], Optional[dict]]] = None, mesh: Optional[Mesh] = None,
               project: str = "tcdiff_torch") -> dict:
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
    `on_save(epoch)`, where given, runs after each of those checkpoints;
    the metrics it returns (a dict, or None) are logged at the same step.

    `mesh`: data parallelism, with `train_step` built on the same mesh;
    `batch_size` is the global batch, each rank steps on its rows of it;
    the files and the log are rank 0's alone; every rank calls the
    checkpoint's save and `on_save` (whose metrics rank 0 logs), so that
    a state split over tp ranks can be gathered. `project`: the
    wandb project of the log (`MetricLogger`), whose config is the JAX
    package's {"lr": the optimizer's, "batch": batch_size}.

    Returns {"steps", "loader" ("native" or "numpy"), "checkpoints",
    "metrics" (the last means logged)}."""
    device = next(state.model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    normalizer = train_ds.normalizer
    run_dir = Path(run_dir)
    ckpt_dir = str(run_dir / "checkpoints")
    host0 = mesh is None or mesh.host0
    config = {"lr": state.optimizer.param_groups[0]["lr"], "batch": batch_size}
    metrics = MetricLogger(str(run_dir), project=project, config=config) if host0 else None
    data_rng = np.random.default_rng(seed)
    timer = StepTimer()
    rows = None if mesh is None else mesh.rows(batch_size)
    motion_s = batch_size * train_ds.poses.shape[2] / DATA_FPS
    use_native = native_available() and not isinstance(train_ds, _SyntheticDataset)
    # the prefetcher reads a fixed number of floats a file (and pads a
    # short file with zeros): take the shape of the dataset's own files
    item_shape = np.load(train_ds.feature_files[0], mmap_mode="r").shape if use_native else None
    out = {"steps": 0, "loader": "native" if use_native else "numpy", "checkpoints": [], "metrics": {}}
    running, n_batches = {}, 0
    try:
        for epoch in range(1, epochs + 1):
            batches = (PrefetchingBatches(train_ds, batch_size, rng=data_rng, item_shape=item_shape, rows=rows)
                       if use_native else train_ds.batches(batch_size, rng=data_rng, rows=rows))
            with trace(profile_dir if epoch == 2 and host0 else None):
                for batch in batches:
                    x = torch.as_tensor(batch["x"], dtype=torch.float32).to(device, non_blocking=True)
                    cond = torch.as_tensor(batch["cond"], dtype=torch.float32).to(device, non_blocking=True)
                    timer.tick()
                    state, m = train_step(state, x, cond, generator)
                    total = m["total"].item()  # waits for the card; the mean over the ranks
                    timer.tock()
                    out["steps"] += 1
                    if not np.isfinite(total):
                        # failure detection the reference lacks: halt with a
                        # rescue checkpoint instead of training on NaNs (every
                        # rank sees the same mean, so every rank halts)
                        path = save_checkpoint(ckpt_dir, state.step, state, normalizer)
                        if host0:
                            out["checkpoints"].append(path)
                            log.error("non-finite loss %s at step %d; rescue checkpoint at %s", total, state.step,
                                      path)
                        raise FloatingPointError(f"non-finite loss at step {state.step}")
                    for k, v in m.items():
                        running[k] = running.get(k, 0.0) + float(v)
                    n_batches += 1
            if isinstance(batches, PrefetchingBatches) and batches.loader is not None:
                out["loader"] = batches.loader
            if epoch % save_interval == 0 and n_batches:
                if host0:
                    means = {k: v / n_batches for k, v in running.items()}
                    means.update(timer.metrics(motion_seconds_per_step=motion_s))
                    means["epoch"] = epoch
                    metrics.log(means, step=state.step)
                    log.info("epoch %d | loss %.4f | %.2f steps/s", epoch, means["total"],
                             means.get("steps_per_sec", float("nan")))
                    out["metrics"] = means
                running, n_batches = {}, 0
                path = save_checkpoint(ckpt_dir, state.step, state, normalizer)  # every rank: a split state gathers
                if host0:
                    out["checkpoints"].append(path)
                extra = on_save(epoch) if on_save is not None else None
                if extra and host0:
                    metrics.log(extra, step=state.step)
    finally:
        if metrics is not None:
            metrics.close()
    return out


# ------------------------------------------------------------ the TCDiff class
def consecutive_slice_indices(feature_files, count: int):
    """Indices of up to `count` CONSECUTIVE slices of one song: long-form
    sampling couples neighbouring half-overlapping slices
    (`model/diffusion.py:502-506`), so its batch must be slices i, i+1, ...
    of one song in order. Picks the song with the longest run."""
    groups = {}
    for i, f in enumerate(feature_files):
        m = re.match(r"(.+)_slice(\d+)$", os.path.splitext(os.path.basename(f))[0])
        if m:
            groups.setdefault(m.group(1), []).append((int(m.group(2)), i))
    best = []
    for slices in groups.values():
        slices.sort()
        run = [slices[0]]
        for prev, cur in zip(slices, slices[1:]):
            run = run + [cur] if cur[0] == prev[0] + 1 else [cur]
            if len(run) >= count:
                break
        if len(run) > len(best):
            best = run
    return [i for _, i in best[:count]]


def gt_traj_x0(x, device) -> torch.Tensor:
    """(B, dn, S, 151) normalized -> the sampler's x_0 (B, S*dn, 3): the XY
    channels (4, 5) in time-major token order and a zero z
    (`TCDiff.py:382-389`)."""
    return _xy_x0(torch.as_tensor(np.asarray(x)[..., 4:6], dtype=torch.float32, device=device))


def _flat_metrics(report: dict) -> dict:
    """An eval report as `eval/<key>` scalars, a sub-report's as
    `eval/<key>/<sub-key>`."""
    flat = {f"eval/{k}": v for k, v in report.items() if isinstance(v, (int, float))}
    for k, v in report.items():
        if isinstance(v, dict):
            flat.update({f"eval/{k}/{kk}": vv for kk, vv in v.items() if isinstance(vv, (int, float))})
    return flat


class TCDiff:
    """The reference's `TCDiff` class (`TCDiff.py:39-657`): the denoiser,
    its diffusion, Adan and EMA, with the five modes of `cli.train`.

    The model runs in `cfg.train.compute_dtype` on `device` (the card
    unless the caller asks for the CPU) through the kernels that
    `ServingKernels.from_env()` chooses (the JAX package's TCDIFF_* flags,
    TCDIFF_INT8 among them), with LayerNorm statistics in that dtype under
    TCDIFF_LN_BF16=1 and its decoder layers recomputed in the backward
    under `cfg.train.remat`.
    `checkpoint_path`: a reference `.pt` or a checkpoint of this program
    (a file, or the run's checkpoint directory: its latest). Sampling uses
    the EMA weights where `use_ema_for_eval`, else the trained ones.

    The loops read their counts from `cfg.train` (`epochs`, `batch_size`,
    `save_interval`) and the data paths from `cfg.data`; `opt`, the parsed
    flags of `cli.args.build_parser`, gives the rest (outputs, the sampler
    mode, the DBN checkpoint, the synthetic data). The val and test loops
    render `cfg.train.epochs` rounds, as the reference's `opt.epochs`.

    `cfg.train.dp`, `cfg.train.tp`: the data- and tensor-parallel sizes
    (dp x tp the world size of the process group the caller joined, dp=-1
    the world over tp; see the module's docstring)."""

    def __init__(self, cfg: TCDiffConfig, checkpoint_path: Optional[str] = None, use_ema_for_eval: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.empty(0, device=device).device  # raises where the device does not exist
        tr = cfg.train
        dtype = torch.bfloat16 if tr.compute_dtype == "bfloat16" else torch.float32
        self.model = DanceDecoder(cfg.model, dtype=dtype, device=self.device, kernels=ServingKernels.from_env(),
                                  remat=tr.remat, ln_bf16=os.environ.get("TCDIFF_LN_BF16", "0") == "1")
        self.model.init_random(torch.Generator().manual_seed(tr.seed))
        self.diffusion = GaussianDiffusion(self.model, cfg.diffusion, device=self.device)
        self.optimizer = Adan(self.model.parameters(), lr=tr.learning_rate, betas=tr.adan_betas, eps=tr.adan_eps,
                              weight_decay=tr.weight_decay)
        self.state = create_train_state(self.model, self.optimizer)
        self.mesh = make_mesh(tr.dp, tr.tp, device=self.device)
        self._solo = False  # within `alone()`: sampling calls no collective
        self._whole: Optional[GaussianDiffusion] = None  # under tp: the serving model of the gathered weights
        self._whole_step: Optional[int] = None  # the state's step when they were gathered
        self.logger = get_logger()
        self.normalizer: Optional[Normalizer] = None
        self.use_ema_for_eval = use_ema_for_eval
        self.logger.info("DanceDecoder parameters: %.2fM", sum(p.numel() for p in self.model.parameters()) / 1e6)
        self.checkpoint_path = checkpoint_path
        if checkpoint_path:
            self._load_checkpoint(checkpoint_path)
        shard_train_state(self.state, self.mesh)  # tp > 1: this rank's slices; tp = 1: whole

    # ------------------------------------------------------------------ setup
    def _check_dancer_count(self, state_dict, path: str) -> None:
        """The fusion projection's input width is d * dancer_num, so a
        checkpoint holds for the dancer count it was trained with only;
        raise where it differs (the reference would fail with a shape
        error, `TCDiff.py:310-625`)."""
        w = state_dict.get("relative_projection_layer.0.weight")
        if w is None:
            return
        dn_ckpt = int(w.shape[1]) // self.cfg.model.latent_dim
        if dn_ckpt != self.cfg.model.dancer_num:
            raise ValueError(
                f"checkpoint {path} was trained for {dn_ckpt} dancers but this run is configured for "
                f"{self.cfg.model.dancer_num} (--required_dancer_num); re-run with --required_dancer_num "
                f"{dn_ckpt} or use a matching checkpoint")

    def _load_checkpoint(self, path: str) -> None:
        """A directory: its latest `ckpt_{step}.pt`. A checkpoint this
        program wrote (it holds the step): the whole train state, as
        `restore_train_state`. Else a reference `.pt` (`TCDiff.py:266-274`):
        its EMA weights (`use_ema_for_eval`) or trained ones become both the
        parameters and the EMA, with its normalizer."""
        if os.path.isdir(path):
            found = latest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(
                    f"no ckpt_*.pt under {path}; a checkpoint of the JAX package (an orbax directory) converts "
                    f"where JAX is installed with `python tools/jax_checkpoint_to_torch.py "
                    f"{path} <out_dir>`")
            path = found
        payload = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
        if "step" in payload:
            self._check_dancer_count(payload["model_state_dict"], path)
            del payload
            self.state, norm = restore_train_state(path, self.state)
            self.logger.info("restored checkpoint %s (step %d)", path, self.state.step)
        else:
            key = "ema_state_dict" if self.use_ema_for_eval else "model_state_dict"
            sd = {k.replace("module.", ""): v for k, v in payload[key].items()}
            self._check_dancer_count(sd, path)
            self.model.load_state_dict(sd, strict=True)
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.state.ema_params[name].copy_(p)
            norm = payload.get("normalizer")
            if norm is not None:
                if isinstance(norm, dict):
                    norm = Normalizer.from_torch_state(norm["scale"], norm["offset"], device=self.device)
                else:  # the reference's pickled Normalizer object
                    norm = Normalizer.from_torch_state(np.asarray(norm.scaler.scale_), np.asarray(norm.scaler.min_),
                                                       device=self.device)
            self.logger.info("loaded reference checkpoint %s", path)
        if norm is not None:
            self.normalizer = norm

    @contextlib.contextmanager
    def eval_weights(self):
        """Within: the model holds the EMA weights where use_ema_for_eval
        (the trained ones are put back after)."""
        if not self.use_ema_for_eval:
            yield
            return
        params = dict(self.model.named_parameters())
        kept = {name: p.detach().clone() for name, p in params.items()}
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(self.state.ema_params[name])
        try:
            yield
        finally:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(kept[name])

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    @property
    def host0(self) -> bool:
        """Whether this rank writes the files (rank 0)."""
        return self.mesh.host0

    def sync_weights(self) -> None:
        """Under tensor parallelism: gather the weights sampling uses (the
        EMA where use_ema_for_eval, else the trained ones) into the whole
        serving model. A collective: every rank calls it, outside
        `alone()`. Without tp, nothing."""
        if self.mesh.tp == 1:
            return
        part = "ema" if self.use_ema_for_eval else "params"
        whole = gather_train_state(self.state, parts=(part,))[part]
        if self._whole is None:
            m = self.model
            model = DanceDecoder(self.cfg.model, dtype=m.dtype, device=self.device, kernels=m.kernels,
                                 ln_bf16=m.ln_bf16)
            self._whole = GaussianDiffusion(model, self.cfg.diffusion, device=self.device)
        with torch.no_grad():
            for name, p in self._whole.model.named_parameters():
                p.copy_(whole[name])
        self._whole_step = self.state.step

    @contextlib.contextmanager
    def serving(self):
        """Within: the diffusion to sample with. Without tp, this model's,
        holding the EMA weights where use_ema_for_eval (`eval_weights`);
        under tp, the whole serving model of the gathered weights,
        gathered first where the state has stepped since (`sync_weights`;
        within `alone()` they must be current)."""
        if self.mesh.tp == 1:
            with self.eval_weights():
                yield self.diffusion
            return
        if self._whole_step != self.state.step:
            if self._solo:
                raise RuntimeError("the gathered weights are stale: call sync_weights on every rank before alone()")
            self.sync_weights()
        yield self._whole

    @contextlib.contextmanager
    def alone(self):
        """Within: `_sample` runs whole on this rank and calls no collective
        (what rank 0 does during training, where the others do not
        follow)."""
        was, self._solo = self._solo, True
        try:
            yield
        finally:
            self._solo = was

    def _render(self, samples, epoch, render_dir: str, **kw) -> np.ndarray:
        """`render_sample` on rank 0; on the others the post-processing
        only, and no file (every rank holds the same samples)."""
        if self.host0:
            return render_sample(samples, self.normalizer, epoch, render_dir, self.cfg.model.dancer_num, **kw)
        samples = torch.as_tensor(samples, dtype=torch.float32, device=self.normalizer.device)
        return postprocess_sample(samples, self.normalizer, self.cfg.model.dancer_num, kw.get("mode", "normal")).poses

    # ------------------------------------------------------------------- data
    def load_datasets(self, opt):
        """(train_ds, test_ds): synthetic with --synthetic, else the AIOZ
        splits under `cfg.data.data_path` through the processed-data cache
        in `cfg.data.processed_data_dir`."""
        m, d = self.cfg.model, self.cfg.data
        opt = argparse.Namespace(**{**vars(opt), "data_path": d.data_path, "processed_data_dir": d.processed_data_dir})
        return load_datasets(opt, dancer_num=m.dancer_num, seq_len=m.seq_len, seed=self.cfg.train.seed,
                             device=self.device)

    # ------------------------------------------------------------ train loop
    def train_loop(self, opt, train_ds=None, test_ds=None) -> dict:
        """Epochs of train steps (the module-level `train_loop`) with, at
        every save interval, two test clips rendered from the sampler
        (`render_eval_samples`; with --no_render sampled and FK'd only)
        and, with --eval_during_train, the metric report logged. Only the
        drawing and writing of the render is caught (and logged): the
        sampling, the FK and the metrics run outside it, so a failed kernel
        launch or device error ends the run."""
        tr = self.cfg.train
        if train_ds is None:
            train_ds, test_ds = self.load_datasets(opt)
        self.normalizer = train_ds.normalizer
        step_fn = make_train_step(self.diffusion, self.optimizer, tr.ema_beta, tr.ema_interval, device=self.device,
                                  mesh=self.mesh)

        def on_save(epoch: int) -> dict:  # every rank; rank 0 samples, alone
            if test_ds is None:
                return {}
            self.sync_weights()  # the collective of tp, made by every rank before rank 0 samples alone
            if not self.host0:
                return {}
            with self.alone():
                self.render_eval_samples(test_ds, epoch, opt.render_dir, render=opt.render)
                return _flat_metrics(self.evaluate_loop(opt, test_ds=test_ds)) if opt.eval_during_train else {}

        # the module-level train_loop, not this method
        return train_loop(self.state, step_fn, train_ds, str(Path(opt.project) / opt.exp_name), epochs=tr.epochs,
                          batch_size=tr.batch_size, save_interval=tr.save_interval, seed=tr.seed,
                          profile_dir=opt.profile_dir, on_save=on_save, mesh=self.mesh,
                          project=opt.wandb_pj_name)

    # -------------------------------------------------------------- sampling
    def _sample(self, cond, x_0, generator: Optional[torch.Generator], mode: str = "normal", full_ref=None):
        """mode: normal (DDIM), long (sliced DDIM, neighbouring slices
        coupled), footwork (the leg channels follow `full_ref`), ddpm (the
        ancestral loop). Returns (b, seq*dn, nfeats) normalized samples.

        Normal mode over a data-parallel mesh whose ranks divide b (and
        outside `alone()`): each rank samples its rows, every draw made at
        the global batch, and the rows are gathered, so every rank returns
        what one process would (the JAX package's sharded `_sample`); tp
        peers sample the same rows (`serving`)."""
        m = self.cfg.model
        cond = torch.as_tensor(np.asarray(cond) if not torch.is_tensor(cond) else cond, dtype=torch.float32,
                               device=self.device)
        shape = (cond.shape[0], m.seq_len * m.dancer_num, m.nfeats)
        x_0 = None if x_0 is None else torch.as_tensor(x_0, dtype=torch.float32, device=self.device)
        with self.serving() as diffusion:
            if mode == "long":
                return diffusion.long_ddim_sample(shape, cond, generator, x_0=x_0)
            if mode == "footwork":
                if full_ref is None:
                    raise ValueError("footwork mode needs a reference motion")
                ref = torch.as_tensor(full_ref, dtype=torch.float32, device=self.device)
                return diffusion.ddim_sample_footwork(shape, cond, generator, x_0=ref)
            if mode == "ddpm":
                return diffusion.p_sample_loop(shape, cond, generator)
            if mode != "normal":
                raise ValueError(f"unknown sample mode {mode!r}")
            if self.mesh.world > 1 and shape[0] % self.mesh.world == 0 and not self._solo:
                rows = self.mesh.rows(shape[0])
                local = diffusion.ddim_sample(shape, rows.take(cond), generator,
                                              x_0=None if x_0 is None else rows.take(x_0), rows=rows)
                return all_gather_rows(local, self.mesh)
            return diffusion.ddim_sample(shape, cond, generator, x_0=x_0)

    def render_eval_samples(self, ds, epoch, render_dir, count=2, mode="normal", fk_out=None, render=True):
        """Sample the first `count` clips of `ds` on their ground-truth
        trajectories and render them (the train-time visual check,
        `TCDiff.py:276-303`). The sampling and the FK raise; a failure to
        draw or write is logged and the poses are still returned, since a
        render must never end training. Returns the FK joints as
        `render_sample` does."""
        items = [ds.get(i) for i in range(min(count, len(ds)))]
        x, cond = np.stack([it[0] for it in items]), np.stack([it[1] for it in items])
        samples = self._sample(cond, gt_traj_x0(x, self.device), self._generator(self.state.step), mode)
        post = postprocess_sample(samples, self.normalizer, self.cfg.model.dancer_num, mode)
        try:  # the drawing and the files only
            return write_sample(post, epoch, render_dir, fk_out=fk_out, name=[it[3] for it in items], sound=False,
                                render=render)
        except Exception as e:
            self.logger.warning("render failed: %s", e)
            return post.poses

    # ----------------------------------------------- eval loop (GT trajectory)
    def given_trajectory_generation_loop(self, opt, test_ds=None) -> None:
        """Diffusion-stage eval on ground-truth trajectories
        (`TCDiff.py:310-431`, `--mode val_without_TrajModel`)."""
        if test_ds is None:
            _, test_ds = self.load_datasets(opt)
        if self.normalizer is None:
            self.normalizer = test_ds.normalizer
        render_dir = os.path.join(opt.render_dir, "VAL_" + opt.exp_name)
        render_count = min(opt.render_count, len(test_ds))
        rng = np.random.default_rng(self.cfg.train.seed)
        mode = opt.sample_mode
        for epoch in range(1, self.cfg.train.epochs + 1):
            if mode == "long":
                idx = consecutive_slice_indices(test_ds.feature_files, render_count)
                if len(idx) < 2:  # no consecutive run (synthetic data): any 2+
                    idx = list(range(min(render_count, len(test_ds))))
                items = [test_ds.get(i) for i in idx]
                batch = {"x": np.stack([it[0] for it in items]), "cond": np.stack([it[1] for it in items]),
                         "filename": [it[2] for it in items], "wav": [it[3] for it in items]}
            else:
                batch = next(iter(test_ds.batches(render_count, rng=rng)))
            b, dn, s, c = batch["x"].shape
            full_ref = (np.transpose(batch["x"], (0, 2, 1, 3)).reshape(b, s * dn, c) if mode == "footwork"
                        else None)
            samples = self._sample(batch["cond"], gt_traj_x0(batch["x"], self.device), self._generator(epoch), mode,
                                   full_ref=full_ref)
            self._render(samples, epoch, render_dir, fk_out=opt.vis_fk_out, name=batch["wav"], sound=False, mode=mode,
                         render=opt.render)
            self.logger.info("[VAL-RENDER SAVED at Epoch %d]", epoch)

    # ----------------------------------------------------------- metric eval
    def evaluate_loop(self, opt, test_ds=None) -> dict:
        """Quality metrics of generated motion against the ground truth
        (`--mode eval`): FID over the kinetic and geometric features,
        diversity, beat alignment, foot skating, collisions, group
        consistency (`eval/metrics.evaluate`), written to
        `{project}/{exp_name}/eval.json`.

        `--traj_source`: `gt` conditions on ground-truth trajectories (the
        reference's stage isolation, `TCDiff.py:310-431`); `dbn` runs the
        whole two-stage pipeline, the DBN rollout and the Kalman filter as
        `test_loop` does; `both` reports the gt metrics flat and the dbn
        ones under `dbn_traj`."""
        if test_ds is None:
            _, test_ds = self.load_datasets(opt)
        if self.normalizer is None:
            self.normalizer = test_ds.normalizer
        count = min(opt.render_count, len(test_ds))
        dn = self.cfg.model.dancer_num
        traj_source = opt.traj_source
        if traj_source not in ("gt", "dbn", "both"):
            raise ValueError(f"traj_source must be gt, dbn or both, not {traj_source!r}")

        def fk_batch(samples):  # FK joints (b, dn, seq, 24, 3), roots (b, dn, seq, 3)
            _, pos, _, joints = fk_sample(samples, self.normalizer, dn)
            return joints, pos.reshape(joints.shape[0], -1, dn, 3).transpose(1, 2)

        batch = next(iter(test_ds.batches(count, rng=np.random.default_rng(0))))
        x = batch["x"]
        b, _, s, c = x.shape
        gt_flat = torch.as_tensor(np.transpose(x, (0, 2, 1, 3)).reshape(b, s * dn, c), dtype=torch.float32,
                                  device=self.device)
        ref_joints, _ = fk_batch(gt_flat)

        def metric_set(x_0):
            gen_joints, gen_roots = fk_batch(self._sample(batch["cond"], x_0, self._generator(self.cfg.train.seed)))
            return evaluate(gen_joints, ref_joints, music_feats=list(batch["cond"]), gen_roots=gen_roots)

        report = {}
        if traj_source in ("gt", "both"):
            report.update(metric_set(gt_traj_x0(x, self.device)))
        if traj_source in ("dbn", "both"):
            dbn_set = metric_set(self._make_dbn_traj_fn(opt)(x, batch["cond"]))
            if traj_source == "dbn":
                report.update(dbn_set)
            else:
                report["dbn_traj"] = dbn_set
        report["traj_source"] = traj_source
        self.logger.info("eval metrics: %s", report)
        if self.host0:
            out = Path(opt.project) / opt.exp_name
            out.mkdir(parents=True, exist_ok=True)
            with open(out / "eval.json", "w") as f:
                json.dump(report, f, indent=2)
        return report

    # ------------------------------------------------ DBN trajectory stage
    def _traj_model(self, opt) -> TrajDecoder:
        return self._load_traj_params(opt, TrajDecoder(self.cfg.traj, device=self.device))

    def _make_dbn_traj_fn(self, opt) -> Callable:
        """The DBN trajectory stage of `test_loop` and `evaluate_loop`
        (`make_dbn_traj_fn` over the DBN of --traj_checkpoint)."""
        return make_dbn_traj_fn(self._traj_model(opt))

    def _load_traj_params(self, opt, traj_model: TrajDecoder) -> TrajDecoder:
        """The DBN's weights: --traj_checkpoint, a reference `.pt`/`.pth`
        (`{'net': state_dict}`) or a checkpoint of the DBN trainer (a file,
        or its checkpoint directory: the latest); without one, random
        weights from the config's seed."""
        path = opt.traj_checkpoint
        if not path:
            self.logger.warning("no --traj_checkpoint given; using random DBN weights")
            return traj_model.init_random(torch.Generator().manual_seed(self.cfg.traj.seed))
        if os.path.isdir(path):
            found = latest_checkpoint(path)
            if found is None:
                raise ValueError(
                    f"no ckpt_*.pt under {path}: a DBN checkpoint of the JAX package (an orbax directory) "
                    f"cannot be read here, where orbax is not installed; convert it where JAX is with "
                    f"`python tools/jax_checkpoint_to_torch.py {path}/ckpt_<step> <out_dir>`, or "
                    f"train the DBN with tcdiff_torch.cli.train_traj")
            path = found
        if not path.endswith((".pt", ".pth")):
            raise ValueError(f"{path}: not a '.pt' DBN checkpoint; a checkpoint of the JAX package (an orbax "
                             f"directory) converts where JAX is installed with `python "
                             f"tools/jax_checkpoint_to_torch.py {path} <out_dir>`")
        return load_reference_traj(traj_model, path)

    # --------------------------------------------------- test loop (full DBN)
    def test_loop(self, opt, test_ds=None) -> None:
        """The whole two-stage pipeline (`TCDiff.py:434-625`, `--mode
        test`): the DBN rollout seeded on the first window_size GT frames,
        the Kalman filter, then the sampler on the generated trajectory."""
        if test_ds is None:
            _, test_ds = self.load_datasets(opt)
        if self.normalizer is None:
            self.normalizer = test_ds.normalizer
        dbn_traj = self._make_dbn_traj_fn(opt)
        render_dir = os.path.join(opt.render_dir, "TEST_" + opt.exp_name)
        render_count = min(opt.render_count, len(test_ds))
        rng = np.random.default_rng(self.cfg.traj.seed)
        for epoch in range(1, self.cfg.train.epochs + 1):
            batch = next(iter(test_ds.batches(render_count, rng=rng)))
            samples = self._sample(batch["cond"], dbn_traj(batch["x"], batch["cond"]), self._generator(epoch))
            self._render(samples, epoch, render_dir, fk_out=opt.vis_fk_out, name=batch["wav"], sound=False,
                         render=opt.render)
            self.logger.info("[TEST-RENDER SAVED at Epoch %d]", epoch)

    # ------------------------------------------------- wav -> dance serving
    def _render_dir(self, opt, wav_path: str) -> str:
        return os.path.join(opt.render_dir, "GEN_" + os.path.splitext(os.path.basename(wav_path))[0])

    def generate(self, wav_path: str, opt) -> np.ndarray:
        """Wav to choreography (`--mode generate`), the module-level
        `generate` on this model, then rendered and exported as the
        long-form clip (several slices) or one clip. Returns its FK joints
        (`render_sample`)."""
        if self.normalizer is None:
            raise ValueError("generate needs a normalizer: a checkpoint, or the synthetic stats of cli.train")
        traj_model = self._traj_model(opt)
        with self.serving() as diffusion:
            samples = generate(wav_path, diffusion, traj_model, self.normalizer,
                               generator=self._generator(self.cfg.train.seed))
        n = samples.shape[0]
        return self._render(samples, "gen", self._render_dir(opt, wav_path), fk_out=opt.vis_fk_out,
                            name=[wav_path] * n, sound=False, mode="long" if n > 1 else "normal", render=opt.render)

    def generate_streaming(self, wav_path: str, opt, on_slice=None, resume_from: int = 0,
                           resume_tail=None) -> np.ndarray:
        """Low-latency wav to dance (`--mode generate --streaming`): the
        module-level `generate_streaming` on this model, then rendered and
        exported as one clip. Returns the motion (L, dn, nfeats),
        normalized."""
        if self.normalizer is None:
            raise ValueError("generate needs a normalizer: a checkpoint, or the synthetic stats of cli.train")
        traj_model = self._traj_model(opt)
        with self.serving() as diffusion:
            full = generate_streaming(wav_path, diffusion, traj_model, self.normalizer,
                                      generator=self._generator(self.cfg.train.seed), on_slice=on_slice,
                                      resume_from=resume_from, resume_tail=resume_tail)
        self._render(full.reshape(1, -1, self.cfg.model.nfeats), "stream", self._render_dir(opt, wav_path),
                     fk_out=opt.vis_fk_out, name=[wav_path], sound=False, render=opt.render)
        return full.cpu().numpy()
