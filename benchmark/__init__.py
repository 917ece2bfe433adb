"""The benchmark of tcdiff_torch, the PyTorch/CUDA port of TCDiff.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on this machine's CUDA cards and
prints one JSON line. See `benchmark/run.py`.
"""
