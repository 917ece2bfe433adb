"""Run one cell of the port's benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with the
CUDA cards the cell asks for (`chips` in BENCHMARK.json). With --trace 0
the line holds the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from a short profiled window after the timed one.
Exits non-zero, printing no result, without the cards, without the
measured package (`tcdiff_torch`), or where JAX or the JAX package was
loaded. The nvcc builds of the port go to its fixed `tcdiff_torch/build/`
in the checkout, so only a checkout's first run compiles.
"""

import time

T0 = time.perf_counter()

import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# nothing the port runs uses Triton; were it to, its cache stays in the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "tcdiff_torch", "build", "triton")

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    faulthandler.dump_traceback_later(300, repeat=True)  # where a run that outlasts its time is stuck
    sys.exit(harness.main(t0=T0))
