"""The benchmark's readers of the port's spans (`benchmark/spans.py`,
`benchmark/metrics/{sampler_ms,glue_ms,launches_per_step}.sample.py` and
`{loss_ms,backward_ms,optim_ms}.train.py`): nothing to read without the
spans' events, and on a CPU-profiled tiny run the host clock's split of
a DDIM step and of a train step."""

import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import device, harness, spans, spec  # noqa: E402
from tcdiff_torch.utils.profiling import TRACER  # noqa: E402
from test_torch_tracing import CFG, CPU, STEPS, _diffusion, _sample, _train  # noqa: E402

SAMPLE = ("sampler_ms.sample", "glue_ms.sample", "launches_per_step.sample")
TRAIN = ("loss_ms.train", "backward_ms.train", "optim_ms.train")


def _cell(name: str, steps: int = STEPS):
    cell = spec.load(name)
    config = dict(cell.config, diffusion=dict(cell.config["diffusion"], sampling_timesteps=steps))
    return dataclasses.replace(cell, config=config)


def _reading(cell, trace):
    return harness.Reading(cell, cell.config["model"], cell.traffic, trace, trace.units, 1.0, 0, None)


def _profiled(fn, units: int, kernels=None):
    """fn() under a CPU profiler, as a Trace of `units` units: the host
    events as `device.capture` keeps them, `kernels` as its device ops."""
    with torch.profiler.profile(activities=CPU) as prof:
        fn()
    host = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()]
    w0, w1 = min(s for _, s, _ in host), max(e for _, _, e in host)
    return device.Trace(kernels or [], host, w1 - w0, units)


@pytest.mark.parametrize("tracer_holds", [False, True])
@pytest.mark.parametrize("cell, names", [("sample.g3.b128", SAMPLE), ("train.g4.b256", TRAIN)])
def test_a_reading_without_span_events_reads_nothing(cell, names, tracer_holds):
    TRACER.clear()
    if tracer_holds:  # roots in the tracer, but none among the profile's host events
        diff = _diffusion()
        with torch.profiler.profile(activities=CPU):
            _sample(diff)
            _train(diff)
    c = spec.load(cell)
    trace = device.Trace([("void tcd::gemm_mma_kernel<x>(y)", 0.0, 0.5)], [("aten::mm", 0.0, 1.0)], 1.0, 1)
    got = harness.read_per_layer(c, _reading(c, trace))
    assert not set(names) & set(got)
    assert got["idle_share." + cell.split(".")[0]] == pytest.approx(50.0)


def test_a_profiled_tiny_request_splits_its_steps_on_the_host_clock():
    diff = _diffusion()
    TRACER.clear()
    _profiled(lambda: _sample(diff), 1)  # a first window, as where the harness profiles again
    kernels = [("k", 0.0, 1e-6)] * (7 * STEPS)
    cell = _cell("sample.g3.b128")
    r = _reading(cell, _profiled(lambda: _sample(diff), 1, kernels))
    got = harness.read_per_layer(cell, r)
    assert set(SAMPLE) <= set(got) and all(got[n] > 0 for n in SAMPLE)
    assert got["launches_per_step.sample"] == pytest.approx(7.0)
    root = TRACER.roots("sample.request")[-1]
    steps = [s for s in root.spans if s.name == "sample.step"]
    kernel = [s for s in root.spans if spans.KERNEL.match(s.name)]
    assert len(kernel) == STEPS * CFG["num_layers"] * 3  # K1, K7 and K2 a layer; nothing nested in them
    step_ms = sum(s.host_ms for s in steps) / STEPS
    kernel_ms = sum(s.host_ms for s in kernel) / STEPS
    assert got["sampler_ms.sample"] + got["glue_ms.sample"] + kernel_ms == pytest.approx(step_ms, rel=1e-9)
    assert 0 < kernel_ms < step_ms
    # a request of another step count than the configuration's is not read
    other = _cell("sample.g3.b128", STEPS + 1)
    assert not set(SAMPLE) & set(harness.read_per_layer(other, _reading(other, r.trace)))


def test_profiled_tiny_train_steps_read_their_phases():
    diff = _diffusion()
    TRACER.clear()
    cell = spec.load("train.g4.b256")
    r = _reading(cell, _profiled(lambda: _train(diff, steps=2), 2))
    got = harness.read_per_layer(cell, r)
    assert set(TRAIN) <= set(got) and all(got[n] > 0 for n in TRAIN)
    roots = TRACER.roots("train.step")
    assert len(roots) == 2
    step_ms = sum(root.record.host_ms for root in roots) / 2
    assert got["loss_ms.train"] + got["backward_ms.train"] + got["optim_ms.train"] < step_ms
    # more units than the profile holds roots: nothing read
    more = _reading(cell, dataclasses.replace(r.trace, units=3))
    assert not set(TRAIN) & set(harness.read_per_layer(cell, more))


WG_ATTN = ("void tcd::attn_mma_kernel<64, true>(tcd::AttnMaps, tcd::AttnArgs, tcd::AttnTrain, unsigned int, int, "
           "int)")


@pytest.mark.parametrize("extra", [0, -1, 1])
def test_the_wgmma_attention_counts_as_the_forward_calls(extra):
    """The wgmma body's instantiation, with its second template argument,
    reads as attn_mma_kernel; a request of exactly num_layers x steps of
    its launches is read whole by attn_roofline.sample, one more or one
    fewer is not read."""
    from benchmark import flops, readers

    assert device.kernel_base(WG_ATTN) == "attn_mma_kernel"
    assert readers.is_attention(WG_ATTN)
    cell = spec.load("sample.g3.b128")
    model = cell.config["model"]
    calls = model["num_layers"] * cell.config["diffusion"]["sampling_timesteps"] + extra
    assert calls - extra == 400
    kernels = [(WG_ATTN, 1e-3 * i, 1e-3 * i + 5e-4) for i in range(calls)]
    trace = device.Trace(kernels, [("aten::mm", 0.0, 1.0)], 1.0, 1)
    peaks = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    r = harness.Reading(cell, model, cell.traffic, trace, 1, 1.0, 0, peaks)
    got = readers.attention_roofline(r, train=False)
    if extra:
        assert got is None
    else:
        bound = flops.attention_bound_s(model, cell.traffic["batch"], 50, 989e12, 3.35e12, False)
        assert got == pytest.approx(100.0 * bound / (calls * 5e-4))
