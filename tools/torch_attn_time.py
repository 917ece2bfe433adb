"""Device times of the attention kernel's bf16 bodies (csrc/attention.cuh:
wgmma and mma.sync), made to compare two trees of the repository on one
card in turns.

    python3 tools/torch_attn_time.py            # every call below
    python3 tools/torch_attn_time.py --ptxas    # and the build's register and spill report

Runs from the root of the tree it lies in, with that tree's kernels and
its chip_smoke.py:
- in any tree, the mma.sync body's forms that no cell runs: K11's TRPE
  form at chip_smoke phase 4's shape (8 rows x 8 heads at 450 x 450, dk
  64) and at the serving cell's 256 rows, and head width 32 (8 heads at
  450 x 450, 256 rows, no table), each on (b, L, h*dk) views, device ms a
  call (chip_smoke.device_ms, calls queued back to back);
- where chip_smoke.py has its phase 4c (compare_attention_bodies): K1's
  and the train forward's calls on both bodies, each held against the
  plain version, beside the bound, with each body's launches.
Prints a line a call and one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tcdiff_torch.ops import _build, attention  # noqa: E402

H, L, ROWS = 8, 450, 256


def mma_rows(gen: torch.Generator) -> list:
    """The mma.sync body's TRPE and dk 32 calls above, a dict each."""
    dev = torch.device("cuda")
    rows_out = []
    for rows, dk, trpe in ((8, 64, True), (ROWS, 64, True), (ROWS, 32, False)):
        heads = lambda: (torch.randn(rows, L, H * dk, generator=gen, device=dev).to(torch.bfloat16)
                         .view(rows, L, H, dk).transpose(1, 2))
        q, k, v = heads(), heads(), heads()
        table = torch.randn(H, 10, dk, generator=gen, device=dev).to(torch.bfloat16) if trpe else None
        dist = torch.randint(0, 10, (rows, L, L), generator=gen, device=dev, dtype=torch.int32) if trpe else None
        ms = chip_smoke.device_ms(lambda: attention.attention(q, k, v, dk**-0.5, table, dist), reps=20)
        row = dict(call=f"{'trpe' if trpe else 'self'} {rows} rows {L}x{L} dk {dk}", device_ms=round(ms, 5),
                   tflops=round(4.0 * rows * H * L * L * dk / ms / 1e9, 1))
        print(json.dumps(row), flush=True)
        rows_out.append(row)
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true", help="print ptxas's register and spill report of the build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attn_time: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all(["attention", "sa_block_train"], verbose=args.ptxas)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = mma_rows(gen)
    if hasattr(chip_smoke, "compare_attention_bodies"):  # a tree with the wgmma body
        rows += chip_smoke.compare_attention_bodies(gen)
    print(json.dumps({"card": chip_smoke.card_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
