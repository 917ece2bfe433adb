"""Seconds per serving request and per train step of the port on one CUDA
card, made to compare two trees of the repository in one machine.

    python3 tools/torch_serve_time.py [--requests 3] [--train-steps 3] [--config per_op]

Runs from the root of the tree it lies in, with that tree's kernels. On
the full-width bf16 DanceDecoder of `chip_smoke.py` (seeded random
weights): one warm-up and `--requests` timed `ddim_sample` requests of
batch 4 in the default configuration (K1/K2), or with `--config per_op`
`long_ddim_sample` requests over 4 slices in the per-op configuration
(K8-K11, as chip_smoke's phase 8), one more under torch.profiler (device
busy time, idle share, chip_smoke.device_profile), then one warm-up and
`--train-steps` timed batch-64 bf16 train steps (none with 0). Prints one
JSON line, with the card's name and power limit and, for each timed
request, the tensor maps the libraries of its wgmma products (default:
K1's, K2's and K7's; per-op: K8's and K9's) looked up and encoded and the
host us they took (null for a library without them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tcdiff_torch import DanceDecoderConfig, DiffusionConfig, ServingKernels  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.ops import _build, gemm  # noqa: E402


def tma_stats(lib: str) -> dict | None:
    """gemm.tma_stats(lib), or None where the tree's library encodes no
    tensor maps (a tree before its kernel ran on the wgmma body)."""
    return gemm.tma_stats(lib) if hasattr(_build.load(lib), "tcd_tma_stats") else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--config", choices=("default", "per_op"), default="default")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg, dcfg = DanceDecoderConfig(dancer_num=3), DiffusionConfig()
    kernels = ServingKernels.per_op(attention=1) if args.config == "per_op" else ServingKernels()
    model = DanceDecoder(cfg, dtype=torch.bfloat16, kernels=kernels).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (chip_smoke.REQ_BATCH, cfg.tokens, cfg.nfeats)
    cond = torch.randn((shape[0], 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda")
    x_0 = 0.1 * torch.randn((shape[0], cfg.tokens, 3), generator=gen, device="cuda")
    sample = diff.long_ddim_sample if args.config == "per_op" else diff.ddim_sample
    request = lambda: sample(shape, cond, generator=gen, x_0=x_0)
    request()
    torch.cuda.synchronize()
    libs = ("ln_rotary_matmul", "ln_matmul") if args.config == "per_op" else ("sa_block", "ff_tail", "ca_block")
    times, maps = [], {lib: [] for lib in libs}
    for _ in range(args.requests):
        before = {lib: tma_stats(lib) for lib in libs}
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for lib, was in before.items():
            now = tma_stats(lib)
            maps[lib].append(None if now is None else {k: now[k] - was[k] for k in now})
    wall, busy, _ = chip_smoke.device_profile(request)
    del model, diff
    torch.cuda.empty_cache()

    step_ms = None
    if args.train_steps:
        model, state, step = chip_smoke.make_trainer(cfg, torch.bfloat16)
        x, tcond = chip_smoke.train_inputs(cfg, chip_smoke.TRAIN_BATCH, 1)
        tgen = torch.Generator(device="cuda").manual_seed(2)
        state, _ = step(state, x, tcond, tgen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.train_steps):
            state, _ = step(state, x, tcond, tgen)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.train_steps
    print(json.dumps({"card": chip_smoke.card_line(), "config": args.config, "s_per_request": times,
                      "tma_per_request": maps,
                      "profiled_wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
                      "train_ms_per_step": step_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
