"""Tile shapes of the bf16 projection's main loop, side by side on one CUDA
card, beside torch.matmul.

    python3 tools/torch_gemm_tiles.py                 # every part
    python3 tools/torch_gemm_tiles.py --only wgmma    # a part: mma, epilogues, backward, wgmma

Builds `tools/gemm_tiles.cu` (the mma.sync loop of
`tcdiff_torch/csrc/gemm_mma.cuh` over a few block tiles, K steps, warp
layouts and ring depths; a bf16 store as the epilogue) and times each
variant at K1's and K2's serving shapes (M = 3600; q/k/v as one 1536-wide
product) and at one train shape (M = 28800), with the calls queued back to
back (chip_smoke.device_ms). For each: microseconds, TFLOP/s, the blocks
an SM holds, and the rate at which the tiles move operands from L2 into
the SMs, M N K 2 (1/BM + 1/BN) bytes over the time. Then the projection
itself (ops/gemm.py) with each of K1's and K2's epilogues at their
shapes, so that the cost of an epilogue is its time less the loop's (v4).
Then the backward's bodies (ops/gemm.py) at the train rows (M = 28800):
the input gradient by shape and epilogue, and the split-row weight
gradient by split count (the count the train kernels use marked), each
with its ordered reduction. Then the wgmma + TMA body (ops/gemm.gemm_wg)
at K8's and K2b's products with their epilogues (128 x 128 tiles, one
block an SM), each with its L2 -> SM rate. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tcdiff_torch.ops import _build, gemm  # noqa: E402
from tcdiff_torch.ops.train_common import weight_splits  # noqa: E402

# variant: (BM, BN, BK, warps along M x N, ring stages, fragments first), as in gemm_tiles.cu
VARIANTS = {
    0: (128, 64, 32, "2x2", 4, False),
    1: (64, 64, 32, "2x2", 4, False),
    2: (128, 64, 64, "2x2", 3, False),
    3: (128, 128, 32, "2x4", 4, False),
    4: (128, 128, 64, "2x4", 3, False),  # csrc/gemm_mma.cuh
    5: (128, 128, 64, "2x4", 3, True),
}
SHAPES = [(3600, 512, 512), (3600, 1536, 512), (3600, 1024, 512), (3600, 512, 1024), (28800, 512, 512)]
EPILOGUES = [(3600, 512, 512, ("store", "store_f32", "bias")), (3600, 1024, 512, ("store", "bias_gelu")),
             (3600, 512, 1024, ("store", "store_f32", "bias_film"))]
L = 450  # rows of one FiLM row


def wgmma(gen) -> None:
    """The wgmma body's tiles at K8's and K2b's products (module docstring)."""
    M, D, FF, L = 3600, 512, 1024, 450
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device="cuda") * std
    x, h = rnd(M, D).bfloat16(), rnd(M, FF).bfloat16()
    wq, wk, wv = (rnd(D, D, std=D**-0.5).bfloat16() for _ in range(3))
    w1, w2 = rnd(FF, D, std=D**-0.5).bfloat16(), rnd(D, FF, std=FF**-0.5).bfloat16()
    b1, b2, fs, fb = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(M // L, D, std=0.1), rnd(M // L, D, std=0.1)
    cases = (  # (label, N, K, gemm_wg's args)
        ("K8 q||k||v store", 3 * D, D, (x, [wq, wk, wv])),
        ("K8 rot-only q store", D, D, (x, wq)),
        ("K2b W1 bias+GELU", FF, D, (x, w1, "bias_gelu", b1)),
        ("K2b W2 bias", D, FF, (h, w2, "bias", b2)),
        ("K2b W2 bias+FiLM", D, FF, (h, w2, "bias_film_t", b2, x, fs, fb, L)),
    )
    print(f"the wgmma + TMA body (ops/gemm.gemm_wg, csrc/gemm_wgmma.cuh) at M = {M}:")
    for label, N, K, args in cases:
        flops = 2 * M * N * K
        ms = chip_smoke.device_ms(lambda: gemm.gemm_wg(*args))
        l2 = M * N * K * 2 * (1 / gemm.WG_BM + 1 / gemm.WG_BN)
        print(f"  {label} {M}x{N}x{K}, {gemm.WG_BM}x{gemm.WG_BN} tiles: {1e3 * ms:.1f} us, "
              f"{flops / ms / 1e9:.0f} TFLOP/s, L2->SM {l2 / ms / 1e9:.2f} TB/s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="mma,epilogues,backward,wgmma",
                    help="comma-separated parts: mma, epilogues, backward, wgmma")
    parts = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "wgmma" in parts:
        wgmma(gen)
    if "mma" not in parts and "epilogues" not in parts and "backward" not in parts:
        return 0
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD / "libgemm_tiles.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                          os.path.join(ROOT, "tools", "gemm_tiles.cu")], capture_output=True, text=True)
    if res.returncode:
        print(res.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(lib_path)).tile_gemm
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                                                  ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for M, N, K in SHAPES if "mma" in parts else ():
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(N, K, generator=gen, device="cuda") * K**-0.5).bfloat16()
        c = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        ref = torch.matmul(a.float(), w.float().t())
        flops = 2 * M * N * K
        lib_ms = chip_smoke.device_ms(lambda: torch.matmul(a, w.t()))
        print(f"{M}x{N}x{K}: torch.matmul {1e3 * lib_ms:.1f} us, {flops / lib_ms / 1e9:.0f} TFLOP/s")
        for v, (bm, bn, bk, warps, stages, pre) in VARIANTS.items():
            occ = ctypes.c_int(0)
            rc = fn(v, a.data_ptr(), w.data_ptr(), c.data_ptr(), M, N, K, stream, ctypes.byref(occ))
            torch.cuda.synchronize()
            err = (c.float() - ref).abs().max().item()
            if rc or err > 2.0**-5 * ref.abs().max().item():
                print(f"  v{v}: launch rc {rc}, max_abs_err {err:.3e}")
                return 1
            ms = chip_smoke.device_ms(lambda: fn(v, a.data_ptr(), w.data_ptr(), c.data_ptr(), M, N, K, stream, None))
            l2 = M * N * K * 2 * (1 / bm + 1 / bn)
            print(f"  v{v} {bm}x{bn}x{bk} warps {warps} stages {stages}{' fragments first' if pre else ''}: "
                  f"{1e3 * ms:.1f} us, {flops / ms / 1e9:.0f} TFLOP/s, {occ.value} blocks/SM, "
                  f"{flops / l2:.0f} FLOP/byte, L2->SM {l2 / ms / 1e9:.2f} TB/s")
    if "epilogues" in parts:
        print("the projection (ops/gemm.py, csrc/gemm_mma.cuh) by epilogue:")
    for M, N, K, epilogues in EPILOGUES if "epilogues" in parts else ():
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(N, K, generator=gen, device="cuda") * K**-0.5).bfloat16()
        film = (0.1 * torch.randn(N, generator=gen, device="cuda"),
                torch.randn(M, N, generator=gen, device="cuda").bfloat16(),
                0.1 * torch.randn(M // L, N, generator=gen, device="cuda"),
                0.1 * torch.randn(M // L, N, generator=gen, device="cuda"), L)
        for epi in epilogues:
            ms = chip_smoke.device_ms(lambda: gemm.gemm(a, w, epi, *film))
            print(f"  {M}x{N}x{K} {epi}: {1e3 * ms:.1f} us, {2 * M * N * K / ms / 1e9:.0f} TFLOP/s")
    if "backward" in parts:
        backward(gen)
    return 0


def backward(gen) -> None:
    """The input gradient and the weight gradient at the train rows."""
    M = 28800
    rnd = lambda *shape, std=1.0: (torch.randn(shape, generator=gen, device="cuda") * std).bfloat16()
    print(f"the input gradient (gemm_nn) at M = {M}:")
    for N, K in ((512, 512), (1024, 512), (512, 1024)):
        a, b = rnd(M, K), rnd(K, N, std=K**-0.5)
        lib_ms = chip_smoke.device_ms(lambda: torch.matmul(a, b))
        for epi in ("store", "store_f32"):
            ms = chip_smoke.device_ms(lambda: gemm.gemm_nn(a, b, epi))
            print(f"  {M}x{N}x{K} {epi}: {1e3 * ms:.1f} us, {2 * M * N * K / ms / 1e9:.0f} TFLOP/s "
                  f"(torch.matmul {1e3 * lib_ms:.1f} us)")
    print(f"the weight gradient (wgrad) over R = {M} rows, by split count:")
    for N, K in ((512, 512), (512, 1024), (1024, 512)):
        g, x = rnd(M, N), rnd(M, K)
        path = weight_splits(M, N, K)
        for splits in sorted({2, 4, 8, 16, 32, 56, path}):
            ms = chip_smoke.device_ms(lambda: gemm.wgrad(g, x, splits))
            print(f"  {N}x{K} x {M} rows, {splits} chunks{' (the path)' if splits == path else ''}: "
                  f"{1e3 * ms:.1f} us, {2 * M * N * K / ms / 1e9:.0f} TFLOP/s")


if __name__ == "__main__":
    sys.exit(main())
