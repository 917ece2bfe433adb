"""Where a train step's device time goes, on one CUDA card.

    python3 tools/torch_profile_train.py [--batch 64] [--steps 3]

Builds the full-width bf16 DanceDecoder of `chip_smoke.py`'s train phase
(8 layers, d=512, dropout 0.1, seeded random weights), runs 2 warm-up
steps, then profiles `--steps` train steps (loss, backward, Adan, EMA)
with torch.profiler, CPU and CUDA activities. Prints the card's name and
power limit, the unprofiled and profiled step times, the device's busy
time and idle share over the profiled window (the union of kernel
intervals), and a table of device time per step by kernel, grouped as the
train blocks' kernels (tcd::) and the rest.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcdiff_torch import DanceDecoderConfig, DiffusionConfig, TrainConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*\)$", "", name).replace("__nv_bfloat16", "bf16")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")

    cfg, tcfg = DanceDecoderConfig(dancer_num=3), TrainConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    opt = Adan(model.parameters(), lr=tcfg.learning_rate, betas=tcfg.adan_betas, eps=tcfg.adan_eps,
               weight_decay=tcfg.weight_decay)
    step = make_train_step(GaussianDiffusion(model, DiffusionConfig()), opt, ema_beta=tcfg.ema_beta)
    state = create_train_state(model, opt)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = 0.3 * torch.randn((args.batch, 3, cfg.seq_len, cfg.nfeats), generator=g, device="cuda")
    cond = torch.randn((args.batch, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=g, device="cuda")

    for _ in range(2):
        state, _ = step(state, x, cond, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, x, cond, g)
    torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t0) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, x, cond, g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events, less the device-side spans of annotations (such as the
    # optimizer step's), which cover kernels already counted
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and "#" not in e.name]
    if not kernels:
        print("the profiler saw no device events", file=sys.stderr)
        return 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e6
    window = (spans[-1][1] - spans[0][0]) / 1e6
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by[short(e.name)][0] += e.time_range.elapsed_us() / 1e3
        by[short(e.name)][1] += 1
    n = args.steps
    print(f"batch {args.batch} bf16: {1e3 * plain_s:.1f} ms/step unprofiled, {1e3 * wall / n:.1f} ms/step "
          f"profiled; device busy {1e3 * busy / n:.1f} ms/step of a {1e3 * window / n:.1f} ms/step kernel "
          f"window, idle share {1 - busy / wall:.3f} of the profiled wall time; "
          f"{len(kernels) / n:.0f} kernel launches per step")
    ours = sum(v[0] for k, v in by.items() if "tcd::" in k)
    print(f"train-block kernels (tcd::) {ours / n:.1f} ms/step, {ours / 1e3 / total:.3f} of kernel time; "
          f"everything else {(1e3 * total - ours) / n:.1f} ms/step")
    print("| device kernel | ms / step | calls / step | share of kernel time |")
    print("|---|---|---|---|")
    for name, (ms, calls) in sorted(by.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"| `{name[:90]}` | {ms / n:.2f} | {calls / n:.0f} | {ms / 1e3 / total:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
