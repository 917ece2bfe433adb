"""Device times of the train blocks (K3, K4, K5, forward + backward), of
the serving cross-attention block (K7), and of K8, K2b and K9, bf16, at
the main path's shapes, made to compare two trees of the repository in
one machine.

    python3 tools/torch_block_time.py                  # all of them
    python3 tools/torch_block_time.py --only k8,k2b    # a part: train, k7, k8, k2b, k9

Runs from the root of the tree it lies in, with that tree's kernels: K3,
K4 and K5 at the train shape (b=64, L=450, Lm=152, d=512, 8x64 heads,
ff=1024, dropout 0.1) and K7 at the serving shape (b=8, L=450, Lm=152),
each one's device time a call (calls queued back to back,
chip_smoke.device_ms: 5 train calls, 20 of K7) and the device time of one
call's kernels by name (torch.profiler, chip_smoke.device_kernels), in
launch order for the row kernels (chain_top_*, rows_bwd_*) and summed for
the attention's (attn_*). K4 also at dropout 0, for the attention's share.
Seeded random inputs; FiLM rows and LayerNorm affines in f32, weights in
bf16, so no wrapper casts. Then K7's q side alone: the LayerNorm-prologue
launch (gemm_lnrot) and the row kernel and product it replaced (ln_rows +
gemm), each kernel's median device us. K8 (self q/k/v with the joined
q||k weight, as every tree takes it, and apart where the tree takes that;
the rot-only cross query) and K2b (with and without FiLM rows) at the
serving shape (b=8, L=450, d=512, ff=1024), and K9 (norm3 -> linear1, N =
1024, and norm4 -> linear3, N = 512, the bias f32 as the path passes it):
device time a call and one call's kernels by name. Prints one JSON line, with
the card's name and power limit. To compare with another tree, copy this
file into it (`git archive` of the parent) and run the two in turns.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from chip_smoke import B, D, FF, H, HD, L, LM, TRAIN_BATCH  # noqa: E402
from tcdiff_torch.models.rotary import angle_table, apply_rotary  # noqa: E402
from tcdiff_torch.ops import (  # noqa: E402
    ca_block, ca_block_train, ff_block, ff_block_train, gemm, layernorm, ln_matmul, ln_rotary_matmul, sa_block_train,
)

ROWS = ("chain_top_fwd", "chain_top_bwd", "rows_bwd", "rot_rows", "ff_tail_bwd_rows", "gelu_bwd_rows")


def profile(fn) -> dict:
    """One fn() under torch.profiler: the device us of each row kernel in
    launch order, the attention's kernels summed, every kernel's launches
    and device us by name, and the kernels' total."""
    _, kernels = chip_smoke.device_kernels(fn)
    rows = collections.defaultdict(list)
    counts, us_by = collections.Counter(), collections.defaultdict(float)
    attn = total = 0.0
    for name, start, end in kernels:
        us = end - start
        total += us
        counts[name] += 1
        us_by[name] += us
        if "attn" in name:
            attn += us
        for r in ROWS:
            if f"{r}_kernel" in name or (r == "rot_rows" and "ln_rows_kernel" in name and "false" in name):
                rows[r].append(us)
    return dict(kernel_us=total, attention_us=attn, launches=sum(counts.values()), rows_us=dict(rows),
                by_kernel=dict(counts), by_kernel_us=dict(us_by))


def serving_k8_k2b_k9(res: dict, parts, rnd, w, ln, film) -> None:
    """K8, K2b and K9 (see the module docstring) into res."""
    dev = "cuda"
    x = rnd(B, L, D).to(torch.bfloat16)
    s, b = ln()
    ang = angle_table(L, D, dev)
    wq, wk, wv = w(HD, D), w(HD, D), w(HD, D)
    wr = torch.cat([wq, wk])
    w1, w2, w3, b1, b2, b3 = w(FF, D), w(D, FF), w(D, D), rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1)
    fs, fb = film(B)
    new = hasattr(gemm, "gemm_wg")  # a tree with the wgmma body
    calls = {}
    if "k8" in parts:
        calls["K8"] = lambda: ln_rotary_matmul.ln_rotary_matmul(x, s, b, ang, wr, wv)
        if new:
            calls["K8 apart"] = lambda: ln_rotary_matmul.ln_rotary_matmul(x, s, b, ang, (wq, wk), wv)
        calls["K8 rot-only"] = lambda: ln_rotary_matmul.ln_rotary_matmul(x, s, b, ang, wq)
    if "k2b" in parts:
        calls["K2b"] = lambda: ff_block.ff_block(x, s, b, w1, b1, w2, b2)
        calls["K2b film"] = lambda: ff_block.ff_block(x, s, b, w1, b1, w2, b2, fs, fb)
    if "k9" in parts:
        calls["K9 linear1"] = lambda: ln_matmul.ln_matmul(x, s, b, w1, b1)
        calls["K9 linear3"] = lambda: ln_matmul.ln_matmul(x, s, b, w3, b3)
    for label, fn in calls.items():
        res[label] = dict(device_ms=chip_smoke.device_ms(fn, reps=20), **profile(fn))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="train,k7,k8,k2b,k9", help="comma-separated parts: train, k7, k8, k2b, k9")
    parts = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, dev, b = torch.bfloat16, "cuda", TRAIN_BATCH
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    film = lambda n: (rnd(n, D, std=0.1), rnd(n, D, std=0.1))
    seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
    res = {}

    def train_block(name, fn, args, diff, kw):
        leaves = [a.detach().clone().requires_grad_(i in diff) if a.is_floating_point() else a
                  for i, a in enumerate(args)]
        out = fn(*leaves, **kw)
        cot = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        step = lambda: torch.autograd.grad(fn(*leaves, **kw), [leaves[i] for i in diff], cot)
        fwd = profile(lambda: fn(*leaves, **kw))
        both = profile(step)
        res[name] = dict(device_ms=chip_smoke.device_ms(step, reps=5), fwd_launches=fwd["launches"],
                         bwd_launches=both["launches"] - fwd["launches"], **both)

    serving_k8_k2b_k9(res, parts, rnd, w, ln, film)
    if "train" in parts:
        sab = (rnd(b, L, D).to(bf16), *ln(), angle_table(L, D, dev), w(HD, D), w(HD, D), w(HD, D), w(D, HD),
               *ln(), *film(b), seeds)
        train_block("K3", sa_block_train.sa_block_train, sab, (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11),
                    dict(nhead=H, rate=chip_smoke.RATE))
        cab = (rnd(b, L, D).to(bf16), rnd(b, LM, D).to(bf16), *ln(), angle_table(L, D, dev),
               angle_table(LM, D, dev), w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), *film(b), seeds)
        cad = (0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13)
        train_block("K4", ca_block_train.ca_block_train, cab, cad, dict(nhead=H, rate=chip_smoke.RATE))
        train_block("K4 rate 0", ca_block_train.ca_block_train, cab, cad, dict(nhead=H, rate=0.0))
        ffb = (rnd(b, L, D).to(bf16), *ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1), *film(b),
               *ln(), w(D, D), rnd(D, std=0.1), seeds)
        train_block("K5", ff_block_train.ff_tail_train, ffb, tuple(range(13)), dict(rate=chip_smoke.RATE))

    if "k7" in parts:
        mem = rnd(B, LM, D).to(bf16)
        k7 = (rnd(B, L, D).to(bf16), *ln(), angle_table(L, D, dev), mem, apply_rotary(mem, angle_table(LM, D, dev)),
              w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln())
        for label, args in (("K7", k7 + (None, None)), ("K7 film", k7 + film(B))):
            fn = lambda args=args: ca_block.ca_block(*args, nhead=H)
            res[label] = dict(device_ms=chip_smoke.device_ms(fn, reps=20), **profile(fn))
        # K7's q side alone: the prologue launch, and the row kernel and the
        # product it replaced (ln_rows + gemm, the same bits), each kernel's
        # median us (ln_rows' wrapper also builds its tables: not counted)
        x, s1, b1, ang, wq = k7[0], k7[1], k7[2], k7[3], k7[6]
        if hasattr(gemm, "gemm_lnrot"):  # a tree from after the prologue
            unfused = lambda: gemm.gemm(
                layernorm.ln_rows(x, s1, b1, 1e-5, angles=ang, normed=False)[1].view(B * L, D), wq)
            res["K7 q"] = dict(
                prologue_us=chip_smoke.kernel_us(lambda: gemm.gemm_lnrot(x, s1, b1, ang, wq), "gemm_lnrot"),
                ln_rows_us=chip_smoke.kernel_us(unfused, "ln_rows_kernel"),
                gemm_us=chip_smoke.kernel_us(unfused, "gemm_mma_kernel"))
    print(json.dumps({"card": chip_smoke.card_line(), "bf16": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
