"""Run-directory helpers and the multi-process start.

`increment_path` (a copy of `tcdiff_tpu/utils/paths.py:14`) mirrors the
reference's non-clobbering run directories (`dataset/preprocess.py:11-30`):
runs/exp -> runs/exp2, runs/exp3, ... so repeated launches never overwrite
earlier experiments. `maybe_init_multihost` joins the process group when
torchrun started the process (`tcdiff_tpu/utils/paths.py:33-45` starts
jax.distributed under a coordinator).
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from tcdiff_torch.parallel.mesh import init_distributed


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        stem_path = path.with_suffix("")
        existing = [p.name for p in stem_path.parent.glob(f"{stem_path.name}{sep}*")]
        nums = []
        for name in existing:
            m = re.fullmatch(rf"{re.escape(stem_path.name)}{re.escape(sep)}(\d+)(?:\..*)?", name)
            if m:
                nums.append(int(m.group(1)))
        n = max(nums) + 1 if nums else 2
        path = stem_path.parent / f"{stem_path.name}{sep}{n}{suffix}"
    directory = path if path.suffix == "" else path.parent
    if mkdir and not directory.exists():
        directory.mkdir(parents=True, exist_ok=True)
    return path


def maybe_init_multihost(device="cuda") -> torch.device:
    """Join torchrun's process group (RANK, WORLD_SIZE, LOCAL_RANK in the
    environment), the counterpart of `accelerate launch` and of the JAX
    package's jax.distributed start; a no-op in a lone process. Returns
    this rank's device (`parallel.mesh.init_distributed`: NCCL on
    `cuda:{LOCAL_RANK}`, gloo on the CPU)."""
    return init_distributed(device)
