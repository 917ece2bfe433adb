"""DBN (Dance-Beat Navigator) trainer.

The port of `tcdiff_tpu/trajdecoder/trainer.py`, which rebuilds the
reference's `TrajDecoder/train_traj.py:26-287`: a random 100-frame window
with a 25-frame prediction shift, the three-term loss (recon + 2 x
inter-dancer distance + 2 x velocity, `train_traj.py:183-196`), AdamW with
betas (0.5, 0.9) and a multi-step lr schedule (x0.05 at iteration 60000,
`utils_model.py:156`, `option_traj.py:53-56`).

Every `print_iter` iterations: the running means logged, a checkpoint in
the reference's `{'net': state_dict}` layout (with the optimizer, the
schedule, the step and the normalizer beside it), and an eval rollout on a
test batch with the Kalman filter (`train_traj.py:211-284`); with
render=True the rollout's first two samples are drawn top-down (GIF, which
needs matplotlib) and every sample's trajectory written as a pkl.

The step computes in float32 under `f32_math`, forward and backward, as
the network's serving forward does.

Data parallelism (`dp`, over torch.distributed as `parallel.mesh` sets it
up): every rank walks the same seeded batch order and reads only its rows, every
draw (the window start, the dropout masks) is made at the global batch
from a generator seeded alike on every rank, the gradients go through one
flat all-reduce, and only rank 0 logs, writes checkpoints and runs the
eval rollout and its renders.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tcdiff_torch.config import TrajDecoderConfig
from tcdiff_torch.parallel.comm import all_reduce_grads_, all_reduce_mean
from tcdiff_torch.parallel.mesh import Mesh, make_mesh
from tcdiff_torch.trajdecoder.kalman import kalman_smooth_batch
from tcdiff_torch.trajdecoder.model import TrajDecoder, f32_math
from tcdiff_torch.trajdecoder.rollout import autoregressive_rollout
from tcdiff_torch.utils.checkpoint import load_checkpoint, save_traj_checkpoint
from tcdiff_torch.utils.logging import MetricLogger, get_logger
from tcdiff_torch.utils.profiling import StepTimer
from tcdiff_torch.viz.traj_render import render_traj_sample


def make_traj_optimizer(model: torch.nn.Module, cfg: TrajDecoderConfig):
    """(AdamW, MultiStepLR): betas cfg.adam_betas, eps 1e-8, decoupled weight
    decay on every parameter (as `optax.adamw` applies it); the lr scaled by
    gamma once the update count reaches each milestone (optax's
    `piecewise_constant_schedule`: count >= milestone), with the schedule
    stepped after every update."""
    optimizer = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=cfg.adam_betas, eps=1e-8,
                                  weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones=list(cfg.lr_milestones),
                                                     gamma=cfg.gamma)
    return optimizer, scheduler


def traj_losses(pred: torch.Tensor, target: torch.Tensor):
    """recon + 2 dis + 2 vel on (b, dn, W, 2) (`train_traj.py:183-196`)."""
    recon = ((pred - target) ** 2).mean()
    if pred.shape[1] > 1:
        dis = (((target[:, 1:] - target[:, :-1]) - (pred[:, 1:] - pred[:, :-1])) ** 2).mean()
    else:
        dis = torch.zeros((), device=pred.device)
    vel = (((target[:, :, 1:] - target[:, :, :-1]) - (pred[:, :, 1:] - pred[:, :, :-1])) ** 2).mean()
    total = recon + 2.0 * dis + 2.0 * vel
    return total, {"recon": recon, "dis_loss": dis, "v_loss": vel}


def window_start(seq_len: int, cfg: TrajDecoderConfig, generator: torch.Generator) -> int:
    """The window's first frame, uniform in [0, S - window - step)."""
    high = seq_len - cfg.window_size - cfg.step
    if high <= 0:
        raise ValueError(f"sequences of {seq_len} frames hold no window of {cfg.window_size} + {cfg.step}")
    return int(torch.randint(0, high, (), generator=generator, device=generator.device).item())


def make_traj_train_step(model: TrajDecoder, optimizer: torch.optim.Optimizer, scheduler,
                         cfg: TrajDecoderConfig, mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_step(x, cond, generator, start=None) -> metrics, which
    updates the model, the optimizer and the schedule in place.

    x: (b, dn, S, 3) normalized roots; cond: (b, >= 2S, 438), on the model's
    device. The window start is drawn from `generator` unless injected (a
    test passes the start the JAX step drew); the dropout masks always come
    from `generator`. The condition window is XY[start, start + w), the
    target the same shifted by `step`, the music cond[2 start, 2 (start + w
    + step)). A parameter without a gradient (the dead `traj_emb`) gets a
    zero one, so that AdamW decays it as optax does. With `mesh`, x and
    cond are this rank's rows of the global batch; the gradients are
    averaged over the ranks before the update and the metrics are means
    over the ranks."""
    w, shift = cfg.window_size, cfg.step
    params = list(model.parameters())

    def train_step(x: torch.Tensor, cond: torch.Tensor, generator: Optional[torch.Generator] = None,
                   start: Optional[int] = None) -> Dict[str, torch.Tensor]:
        if start is None:
            start = window_start(x.shape[2], cfg, generator)
        xy = x[..., :2]
        x_cond, x_target = xy[:, :, start:start + w], xy[:, :, start + shift:start + shift + w]
        music = cond[:, 2 * start:2 * (start + w + shift)]
        optimizer.zero_grad(set_to_none=True)
        with f32_math():
            pred = model.forward_train(x_cond, music, generator, mesh)
            total, parts = traj_losses(pred, x_target.float())
            total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            all_reduce_grads_([p.grad for p in params], mesh)
            parts = all_reduce_mean({**parts, "total": total}, mesh)
            total = parts.pop("total")
        optimizer.step()
        scheduler.step()
        return {**{k: v.detach() for k, v in parts.items()}, "total": total.detach()}

    return train_step


class TrajTrainer:
    """Iteration-based DBN training on one device a rank (the card unless
    the caller asks for the CPU). The weights are drawn from cfg.seed, and
    so is every draw of the steps (windows and dropout masks, from one
    generator on the device) and the order of the batches (numpy). `dp`:
    the data-parallel size, -1 or the world size of the process group
    (`parallel.mesh.make_mesh`); the batch size is the global one."""

    def __init__(self, cfg: TrajDecoderConfig, dancer_num: int = 3, device="cuda", dp: int = -1):
        self.cfg = cfg
        self.dancer_num = dancer_num
        self.model = TrajDecoder(cfg, device=device).init_random(torch.Generator().manual_seed(cfg.seed))
        self.device = self.model.device
        self.mesh = make_mesh(dp, 1, device=self.device)
        self.optimizer, self.scheduler = make_traj_optimizer(self.model, cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0
        self.logger = get_logger()
        self.checkpoints: list = []  # the paths written, in order
        self.losses: list = []  # every step's total loss
        self.step_seconds: list = []  # every step's wall time, the card waited for
        self.last_eval: Optional[np.ndarray] = None
        self.renders: list = []  # the files the eval renders wrote (render=True)
        self._step_fn = make_traj_train_step(self.model, self.optimizer, self.scheduler, cfg, self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info("TrajDecoder parameters: %.2fM", n_params / 1e6)

    def restore(self, path: str):
        """Resume from a checkpoint this trainer wrote: the network, the
        optimizer, the schedule and the step. Returns its normalizer."""
        payload = load_checkpoint(path, device=self.device)
        self.model.load_state_dict(payload["net"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])
        return payload["normalizer"]

    def eval_rollout(self, batch, smooth: bool = True) -> np.ndarray:
        """The seeded autoregressive rollout over a host batch, Kalman
        smoothed: (b, dn, L, 2) numpy."""
        x = torch.as_tensor(batch["x"], dtype=torch.float32, device=self.device)[..., :2]
        cond = torch.as_tensor(batch["cond"], dtype=torch.float32, device=self.device)
        traj = autoregressive_rollout(self.model, x[:, :, :self.cfg.window_size], cond, self.cfg.window_size,
                                      self.cfg.step)
        if smooth:
            traj = kalman_smooth_batch(traj)
        return traj.cpu().numpy()

    def train(self, train_ds, test_ds=None, total_iter: Optional[int] = None, out_dir: str = "runs/traj",
              render: bool = False, batch_size: Optional[int] = None) -> "TrajTrainer":
        cfg = self.cfg
        total = total_iter if total_iter is not None else cfg.total_iter
        bs = batch_size or cfg.batch_size
        if bs > len(train_ds):  # drop_last batching would yield nothing
            self.logger.warning("batch %d > dataset %d; clamping", bs, len(train_ds))
            bs = len(train_ds)
        out = Path(out_dir)
        host0 = self.mesh.rank == 0  # only rank 0 logs and writes files
        metrics = MetricLogger(str(out), config={"lr": cfg.lr, "batch": bs}) if host0 else None
        data_rng = np.random.default_rng(cfg.seed)
        timer = StepTimer()

        rows = self.mesh.rows(bs)

        def cycle():
            while True:
                yield from train_ds.batches(bs, rng=data_rng, rows=rows)

        it = cycle()
        running, n = {}, 0
        try:
            while self.step < total:
                batch = next(it)
                x = torch.as_tensor(batch["x"], dtype=torch.float32, device=self.device)
                cond = torch.as_tensor(batch["cond"], dtype=torch.float32, device=self.device)
                timer.tick()
                m = {k: float(v) for k, v in self._step_fn(x, cond, self.generator).items()}  # waits for the card
                self.step_seconds.append(timer.tock())
                self.step += 1
                self.losses.append(m["total"])
                for k, v in m.items():
                    running[k] = running.get(k, 0.0) + v
                n += 1
                if self.step % cfg.print_iter == 0 and host0:
                    means = {k: v / n for k, v in running.items()}
                    means.update(timer.metrics())
                    metrics.log(means, step=self.step)
                    self.logger.info("Train. Iter %d : Loss. %.5f recon. %.5f dis_loss. %.5f v_loss. %.5f",
                                     self.step, means["total"], means["recon"], means["dis_loss"], means["v_loss"])
                    running, n = {}, 0
                    self.checkpoints.append(save_traj_checkpoint(
                        str(out / "ckpt"), self.step, self.model, self.optimizer, self.scheduler,
                        train_ds.normalizer))
                    if test_ds is not None:
                        eval_batch = next(iter(test_ds.batches(min(bs, len(test_ds)))))
                        self.last_eval = self.eval_rollout(eval_batch)
                        if render:
                            self.renders += render_traj_sample(self.last_eval, str(out / "renders"),
                                                               epoch=self.step, names=eval_batch["wav"],
                                                               pkl_out=str(out / "traj_pkl"))
        finally:
            if metrics is not None:
                metrics.close()
        return self
