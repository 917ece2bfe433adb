"""A run of a cell on the CPU at a small width, the program in float32 (its
plain versions), held to the cell's limits, for the benchmark's own tests."""

import time

from benchmark import harness, spec

TINY_MODEL = dict(seq_len=8, latent_dim=64, ff_size=128, num_layers=2, num_heads=2, head_dim=32, cond_feature_dim=12,
                  dancer_num=2)
TINY_TRAFFIC = {"sample": {"batch": 3, "check_clips": 4, "pool": 2},
                "train": {"batch": 4, "check_block_rows": 3, "pool": 4, "estimate_steps": 1}}


def tiny_run(cell_name: str, seed: int = 2**31 + 12345, faults=(), traffic=None, root=spec.ROOT) -> harness.Run:
    cell = spec.load(cell_name, root)
    tr = dict(TINY_TRAFFIC[cell.traffic["kind"]], **(traffic or {}))
    if tr.get("dp", cell.traffic.get("dp", 1)) > 1:  # data parallelism: two ranks over gloo
        tr.update(dp=2, batch=2)
    return harness.Run(cell, seed, 0.5, False, time.perf_counter(), device="cpu", model_overrides=TINY_MODEL,
                       traffic_overrides=tr, backend="gloo", faults=tuple(faults), precision="float32")


def line(run: harness.Run) -> dict:
    return harness.result_line(run, harness.execute(run), "cpu")
