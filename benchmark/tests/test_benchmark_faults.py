"""A run with the timed path broken underneath comes out not correct: one
case for each fault a cell can have (`benchmark/faults.py`), on the CPU
at a small width, the data-parallel step over two ranks on gloo; and the
same run unbroken comes out correct. A rank process that loads JAX is
found, whichever rank it is."""

import pytest

from _tiny import line, tiny_run

from benchmark import harness

DP = {"dp": 2}
CASES = [
    ("sample.g3.b128", (), None), ("sample.g3.b128", ("answer_altered",), None),
    ("train.g4.b256", (), None), ("train.g4.b256", ("state_unchanged",), None),
    ("train.g4.b256", ("half_batch",), None), ("train.g4.b256", ("leaf_zeroed",), None),
    ("train.g4.b256", (), DP), ("train.g4.b256", ("no_exchange",), DP), ("train.g4.b256", ("state_unchanged",), DP),
    ("train.g4.b256", ("half_batch",), DP), ("train.g4.b256", ("leaf_zeroed",), DP),
]


@pytest.mark.parametrize("cell,faults,traffic", CASES,
                         ids=[f"{c}{'.dp2' if t else ''}-{'+'.join(f) or 'sound'}" for c, f, t in CASES])
def test_a_fault_turns_correct_false(cell, faults, traffic):
    got = line(tiny_run(cell, faults=faults, traffic=traffic))
    assert got["correct"] is (not faults), got["checks"]


@pytest.mark.parametrize("faults", [(), ("jax_in_rank1",)], ids=["sound", "jax_in_rank1"])
def test_jax_loaded_in_another_rank_is_found(faults):
    out = harness.execute(tiny_run("train.g4.b256", faults=faults, traffic=DP))
    assert harness.forbidden_loaded(out) == (["jax"] if faults else [])
