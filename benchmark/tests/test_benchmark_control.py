"""The controls fail the cells' comparison, on the card (marked `cuda`;
skips without one), at the published widths and a batch a test run
holds: the float32 reference with its products' operands in fp8 (the
precision below the configuration's bf16) put in the program's place fails
`sample.g3.b128`'s x0 limit and a train cell's limits, and the sampler's
step rounded to bf16 fails the step's limit, while the program itself
passes. (The port's own int8 path does not fail the x0 limit: PERF.md
§7.) The readings at the cells' own sizes, which the limits were set
from, come from `benchmark/tools/control.py`."""

import time

import pytest
import torch

from benchmark import compare, harness, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _run(cell, seed, **kw):
    return harness.Run(spec.load(cell), seed, 0.1, False, time.perf_counter(), **kw)


@pytest.mark.parametrize("seed", [5, 6])
def test_the_controls_fail_the_sampling_limits(card, seed):
    from benchmark.drivers import sample
    from benchmark.tools.control import fp8_mm

    small = {"batch": 8, "check_clips": 8}
    sound = harness.execute(_run("sample.g3.b128", seed, traffic_overrides=small))
    assert all(value <= limit for value, limit in sound.checks.values())
    fp8 = sample._run(_run("sample.g3.b128", seed, traffic_overrides=small), control_mm=fp8_mm)
    assert fp8.checks["x0_rel_err"][0] > fp8.checks["x0_rel_err"][1]
    step = sample._run(_run("sample.g3.b128", seed, traffic_overrides=small), round_update=torch.bfloat16)
    assert step.checks["update_rel_err"][0] > step.checks["update_rel_err"][1]


@pytest.mark.parametrize("cell", ["train.g4.b256"])
def test_fp8_products_fail_a_training_limit(card, cell):
    from benchmark.drivers import train
    from benchmark.tools.control import fp8_mm

    run = _run(cell, 5, traffic_overrides={"batch": 16, "check_block_rows": 16})
    ref = train.reference(run, card)
    got = compare.train_numbers(train.reference(run, card, mm=fp8_mm), ref)
    assert any(got[k] > lim for k, lim in run.cell.limits.items())
