"""Per-block phase times of the wgmma + TMA body (csrc/gemm_wgmma.cuh) on
the card, at K8's and K2b's serving shapes (M = b L = 3600, d = 512,
ff = 1024, bf16).

    python3 tools/torch_wg_trace.py

Builds an instrumented copy of csrc/gemm.cu into tcdiff_torch/build/
wgtrace (thread 0 of each block records %globaltimer at its start, after
the barriers' set-up, after the K loop and after its share of the
epilogue, and its SM), runs each product twice through the copy's entry
point (tcd_gemm_wg) and prints, for the second run: the blocks and the
SMs they ran on, the span from the first start to the last end, the
share of 132 SMs x the span the blocks were busy, the median and largest
us of each phase (set-up, K loop, epilogue) and the start times of every
twelfth block, which show the rounds of blocks. The instrumented copy
times itself: read the phases against each other, and time the real
kernels with tools/torch_block_time.py or chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tcdiff_torch.ops import _build, gemm  # noqa: E402

TRACE = '''
__device__ unsigned long long tcd_trace[65536][8];
__device__ __forceinline__ unsigned long long tcd_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''
PATCHES = (  # (text of gemm_wgmma.cuh's gemm_wg_kernel, the same with a record added)
    ("  const WgRing ring = wg_ring(tcd_smem);\n  const int nk = (K + WBK - 1) / WBK;\n",
     "  const unsigned long long t_start = tcd_now();\n  const int bid = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "  const WgRing ring = wg_ring(tcd_smem);\n  const int nk = (K + WBK - 1) / WBK;\n"),
    ("  if (threadIdx.x >= 256) {\n",
     "  if (threadIdx.x == 0) {\n    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    tcd_trace[bid][0] = t_start;\n    tcd_trace[bid][1] = tcd_now();\n    tcd_trace[bid][4] = sm;\n  }\n"
     "  if (threadIdx.x >= 256) {\n"),
    ("    wg_consume(ring, nk, wg, d);\n\n",
     "    wg_consume(ring, nk, wg, d);\n    if (threadIdx.x == 0) tcd_trace[bid][2] = tcd_now();\n\n"),
    ("      st_vec<8>(c + (size_t)m * N + n, o);\n    }\n",
     "      st_vec<8>(c + (size_t)m * N + n, o);\n    }\n    if (threadIdx.x == 0) tcd_trace[bid][3] = tcd_now();\n"),
)
READ = '''
extern "C" int tcd_trace_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, tcd::tcd_trace);
  return (int)cudaMemset(p, 0, sizeof(tcd::tcd_trace));
}
extern "C" int tcd_trace_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, tcd::tcd_trace, (size_t)n * 8 * sizeof(unsigned long long));
}
'''


def build() -> ctypes.CDLL:
    """The instrumented copy of csrc/gemm.cu, built and loaded."""
    dst = os.path.join(str(_build.BUILD), "wgtrace")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(str(_build.CSRC), dst)
    path = os.path.join(dst, "gemm_wgmma.cuh")
    src = open(path).read()
    src = src.replace("namespace tcd {\n", "namespace tcd {\n" + TRACE, 1)
    for old, new in PATCHES:
        if old not in src:
            raise RuntimeError(f"gemm_wgmma.cuh no longer holds {old.strip()[:50]!r}: update the patches")
        src = src.replace(old, new, 1)
    open(path, "w").write(src + READ)
    lib = os.path.join(dst, "libgemm_trace.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(dst, "gemm.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr[:4000]}")
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    lib = build()
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def entry(name, struct, ten, dims):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        args = struct(**{k: t.data_ptr() for k, t in ten.items() if t is not None}, **dims)
        return lambda: fn(1, ctypes.byref(args), stream())

    B, L, D, FF = 8, 450, 512, 1024
    M = B * L
    x = rnd(B, L, D).to(bf)
    wq, wk, wv = (rnd(512, D, std=D**-0.5).to(bf) for _ in range(3))
    w1, w2 = rnd(FF, D, std=D**-0.5).to(bf), rnd(D, FF, std=FF**-0.5).to(bf)
    b1, b2 = rnd(FF, std=0.1), rnd(D, std=0.1)
    h, fs, fb = rnd(M, FF).to(bf), rnd(B, D, std=0.1), rnd(B, D, std=0.1)
    outs = [torch.empty(M, FF, dtype=bf, device=dev) for _ in range(3)]
    xa = x.view(M, D)

    def by_tma(a, ws, epi=0, bias=None, resid=None, fsx=None, fbx=None):
        ten = dict(bias=bias, resid=resid, fs=fsx, fb=fbx, **{f"a{i}": a for i in range(len(ws))},
                   **{f"w{i}": w for i, w in enumerate(ws)}, **{f"c{i}": outs[i] for i in range(len(ws))})
        dims = dict(M=a.shape[0], K=a.shape[1], L=L, epi=epi, groups=len(ws),
                    **{f"n{i}": w.shape[0] for i, w in enumerate(ws)})
        return entry("tcd_gemm_wg", gemm._WgArgs, ten, dims)

    gelu, bias_, film_t = (gemm.WG_EPILOGUES[k] for k in ("bias_gelu", "bias", "bias_film_t"))
    cases = (
        ("q|k|v by TMA, store", by_tma(xa, [wq, wk, wv]), 12 * 29),
        ("W1 by TMA, bias+GELU", by_tma(xa, [w1], gelu, b1), 8 * 29),
        ("W1 by TMA, store", by_tma(xa, [w1]), 8 * 29),
        ("K2b W2 bias+FiLM", by_tma(h, [w2], film_t, b2, xa, fs, fb), 4 * 29),
        ("K2b W2 bias", by_tma(h, [w2], bias_, b2), 4 * 29),
        ("512x512 by TMA, store", by_tma(xa, [wq]), 4 * 29),
    )
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    for label, run, blocks in cases:
        for i in range(2):  # the second run is the one read
            if i:
                torch.cuda.synchronize()
                lib.tcd_trace_clear()
            if run() != 0:
                raise RuntimeError(f"{label}: launch failed")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (blocks * 8))()
        lib.tcd_trace_read(buf, blocks)
        rows = [buf[8 * i:8 * i + 8] for i in range(blocks)]
        first = min(r[0] for r in rows)
        span = (max(r[3] for r in rows) - first) / 1e3
        phase = lambda i, j: [(r[j] - r[i]) / 1e3 for r in rows]
        q = lambda v: f"{statistics.median(v):.2f}/{max(v):.2f}"
        starts = sorted((r[0] - first) / 1e3 for r in rows)
        busy = sum((r[3] - r[0]) / 1e3 for r in rows) / (132 * span)
        print(f"{label}: {blocks} blocks on {len(set(r[4] for r in rows))} SMs, span {span:.1f} us, busy "
              f"{busy:.2f}; median/max us: set-up {q(phase(0, 1))}, K loop {q(phase(1, 2))}, "
              f"epilogue {q(phase(2, 3))}; starts (us) " + ", ".join(f"{t:.1f}" for t in starts[::12]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
