"""The benchmark is driven by its files: every cell, configuration, traffic
mix, limit and per-layer metric of BENCHMARK.json is read from its own
file, and files dropped into place add a cell and a metric."""

import json
import os
import shutil

import pytest

from benchmark import device, harness, spec
from _tiny import line, tiny_run

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_read_from_its_files(cell):
    c = spec.load(cell)
    assert c.config["model"]["dancer_num"] in (3, 4) and c.config["precision"] == "bfloat16"
    assert spec.driver(c.traffic["kind"]).run
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    readers = spec.readers(c)
    assert readers and set(readers) == {m["name"] for m in c.per_layer}


def test_every_metric_and_config_is_used():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def _reading(cell, kernels, units=1):
    trace = device.Trace(kernels, [("aten::mm", 0.0, 1.0)], 1.0, units)
    return harness.Reading(cell, cell.config["model"], cell.traffic, trace, units, 1.0, 2**30,
                           device.peaks("NVIDIA H100 80GB HBM3"))


def test_files_dropped_into_place_add_a_cell_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="tcdiff-g5", file="benchmark/configs/tcdiff-g5.json"))
    conf = json.load(open(root / "benchmark/configs/tcdiff-g3.json"))
    conf["model"]["dancer_num"] = 5
    (root / "benchmark/configs/tcdiff-g5.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/ddim_b8.json").write_text(
        json.dumps(dict(json.load(open(root / "benchmark/traffic/ddim_b128.json")), batch=8)))
    shutil.copy(root / "benchmark/limits/sample.g3.b128.json", root / "benchmark/limits/sample.g5.b8.json")
    (root / "benchmark/metrics/busy_ms.sample.py").write_text(
        "def read(r):\n    return 1e3 * r.trace.busy_s / r.trace.units\n")
    bench["workloads"].append({"name": "sample.g5.b8", "config": "tcdiff-g5", "traffic": "ddim_b8", "chips": 1,
                               "why": "a new cell"})
    bench["end_to_end"][0]["workloads"].append("sample.g5.b8")
    bench["per_layer"].append({"name": "busy_ms.sample", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "motion_s_per_s", "workloads": ["sample.g5.b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("sample.g5.b8", str(root))
    assert cell.config["model"]["dancer_num"] == 5 and cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.end_to_end] == ["motion_s_per_s", "setup_s"]
    got = harness.read_per_layer(cell, _reading(cell, [("k", 0.0, 0.25)]))
    assert got == {"busy_ms.sample": pytest.approx(250.0)}  # the cell is in no other metric's list
    run = tiny_run("sample.g5.b8", root=str(root))
    assert run.model_cfg["dancer_num"] == 2  # the CPU test's width
    assert line(run)["correct"]


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    cell = spec.load("train.g4.b256")
    got = harness.read_per_layer(cell, _reading(cell, [("void tcd::gemm_mma_kernel<x>(y)", 0.0, 0.5)]))
    assert "attn_roofline.train" not in got and "allreduce_ms.train" not in got
    assert got["idle_share.train"] == pytest.approx(50.0)


def test_kernel_names_reduce_to_their_function():
    assert device.kernel_base("void tcd::attn_mma_kernel<__nv_bfloat16, 64, (int)2>(tcd::Args)") == "attn_mma_kernel"
    assert device.kernel_base("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)") == \
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
    assert device.kernel_base("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, "
                              "false>(int, float, float const*)") == "vectorized_layer_norm_kernel"
