"""Metrics logging: JSONL always, wandb/TensorBoard when importable.

A copy of `tcdiff_tpu/utils/logging.py`. The reference logs train losses
to Weights & Biases every save interval (`TCDiff.py:208,258-265,307`) and
the DBN trainer to TensorBoard and a file logger
(`TrajDecoder/train_traj.py:40-41,217-219`,
`TrajDecoder/utils/utils_model.py:131-145`). Neither is guaranteed to be
installed, so the primary sink is an append-only `metrics.jsonl` (one JSON
object a log call), with wandb and TensorBoard mirrored where importable.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Mapping, Optional


def get_logger(log_dir: Optional[str] = None, name: str = "tcdiff_torch") -> logging.Logger:
    """Stream and optional file logger (reference `utils_model.py:131-145`)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Append-only JSONL metrics with optional wandb / TensorBoard mirrors."""

    def __init__(self, log_dir: str, project: str = "tcdiff_torch", config: Optional[Mapping] = None,
                 use_wandb: bool = True, use_tensorboard: bool = True):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._t0 = time.time()

        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=dict(config or {}))
            except Exception:
                self._wandb = None

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None

        if config:
            self._jsonl.write(json.dumps({"_config": dict(config)}) + "\n")

    def log(self, metrics: Mapping, step: int) -> None:
        row = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._jsonl.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)
        if self._tb is not None:
            for k, v in row.items():
                if isinstance(v, float) and k != "wall_s":
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
