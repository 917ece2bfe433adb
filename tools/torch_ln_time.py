"""Device times of the LayerNorm row body (K10) and of the serving blocks
whose LayerNorms it runs or that fold them into a product's epilogue (K1,
K2, K6), bf16, at the serving shapes, made to compare two trees of the
repository in one machine.

    python3 tools/torch_ln_time.py

Runs from the root of the tree it lies in, with that tree's kernels:
K10 (`layernorm`) at 3600 and 28800 rows of 512 beside F.layer_norm on the
same input, then K1 (with FiLM), K2 and K6 (with and without its FF
section) at b=8, L=450, Lm=152, d=512, 8x64 heads, ff=1024: each one's
device time (20 calls queued back to back, chip_smoke.device_ms: a tree
whose call launches ~25 kernels fills the launch queue at 50; null where
the host still never gets ahead of the device), per-call time (median of 20
CUDA-event timings of one call, chip_smoke.time_ms, which holds the
wrapper's host work) and the device time of one call's kernels by name
(torch.profiler, chip_smoke.device_kernels). Seeded random inputs; FiLM
rows in f32. Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import collections
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from chip_smoke import B, D, FF, H, HD, L, LM, TRAIN_BATCH  # noqa: E402
from tcdiff_torch.models.rotary import angle_table  # noqa: E402
from tcdiff_torch.ops import ff_block, layer, layernorm, sa_block  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device="cuda") * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    film = lambda: (rnd(B, D, std=0.1), rnd(B, D, std=0.1))
    res = {}

    def both(fn):
        try:
            dev = chip_smoke.device_ms(fn, reps=20)
        except chip_smoke.SmokeFailure:
            dev = None
        by = collections.defaultdict(float)
        for name, start, end in chip_smoke.device_kernels(fn)[1]:
            by[name] += (end - start) / 1e3
        return dict(device_ms=dev, call_ms=chip_smoke.time_ms(fn), kernel_ms=sum(by.values()), by_kernel=by)

    s, b = ln()
    sb, bb = s.to(bf16), b.to(bf16)  # F.layer_norm's affine in x's dtype
    for rows in (B * L, TRAIN_BATCH * L):
        x = (2.0 * rnd(rows // L, L, D) + 0.5).to(bf16)
        res[f"K10 {rows}x{D}"] = dict(
            device_ms=chip_smoke.device_ms(lambda x=x: layernorm.layernorm(x, s, b, 1e-6)),
            layer_norm_device_ms=chip_smoke.device_ms(lambda x=x: F.layer_norm(x, (D,), sb, bb, 1e-6)))

    x = rnd(B, L, D).to(bf16)
    angles = angle_table(L, D, "cuda")
    sa = (x, *ln(), angles, w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), None, None, *film())
    res["K1 film"] = both(lambda: sa_block.sa_block(*sa, nhead=H))
    ff = (x, *ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1), *film(), *ln(), w(D, D), rnd(D, std=0.1))
    res["K2"] = both(lambda: ff_block.ff_tail(*ff))
    head = (x, angles, *ln(), w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), *film(),
            *ln(), w(HD, D), w(D, HD), *ln(), rnd(B, LM, HD).to(bf16), rnd(B, LM, HD).to(bf16), *film())
    tail = (*ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1), *film(), *ln(), w(D, D), rnd(D, std=0.1))
    res["K6"] = both(lambda: layer.layer(*head, *tail, nhead=H))
    res["K6 without FF"] = both(lambda: layer.layer(*head, nhead=H, include_ff=False))
    print(json.dumps({"card": chip_smoke.card_line(), "bf16": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
