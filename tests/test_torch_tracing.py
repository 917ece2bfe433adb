"""The port's spans (`tcdiff_torch/utils/profiling.py`): off while no
profiler records, and under a CPU torch.profiler session the tree of a
sampling request (request, cond, steps, guided calls, decoder layers,
kernel call sites) and of a train step (its phases in order, the kernels'
backward spans under train.backward, one all-reduce span a step under
data parallelism)."""

import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import _torch_parallel as tp  # noqa: E402
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402
from tcdiff_torch.utils import profiling  # noqa: E402
from tcdiff_torch.utils.profiling import TRACER, Tracer, span  # noqa: E402

CFG = dict(nfeats=151, seq_len=8, latent_dim=64, ff_size=64, num_layers=2, num_heads=4, cond_feature_dim=16,
           dancer_num=2, head_dim=16, dropout=0.1)
STEPS = 3
PHASES = ["train.loss", "train.backward", "train.grad_norm", "train.adan", "train.ema"]
CPU = [torch.profiler.ProfilerActivity.CPU]


def _diffusion(remat: bool = False):
    model = DanceDecoder(DanceDecoderConfig(**CFG), device="cpu", remat=remat).init_random(
        torch.Generator().manual_seed(0))
    return GaussianDiffusion(model, DiffusionConfig(sampling_timesteps=STEPS), device="cpu")


def _sample(diff):
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 2 * CFG["seq_len"] + 1, CFG["cond_feature_dim"]), generator=g)
    x_0 = 0.1 * torch.randn((2, CFG["seq_len"] * CFG["dancer_num"], 3), generator=g)
    return diff.ddim_sample((2, CFG["seq_len"] * CFG["dancer_num"], CFG["nfeats"]), cond, generator=g, x_0=x_0)


def _train(diff, steps: int = 1):
    opt = Adan(diff.model.parameters(), lr=1e-4)
    state, step = create_train_state(diff.model, opt), make_train_step(diff, opt, device="cpu")
    g = torch.Generator().manual_seed(2)
    x = 0.3 * torch.randn((2, CFG["dancer_num"], CFG["seq_len"], CFG["nfeats"]), generator=g)
    cond = torch.randn((2, 2 * CFG["seq_len"] + 1, CFG["cond_feature_dim"]), generator=g)
    for _ in range(steps):
        state, _ = step(state, x, cond, g)
    return state


def _children(root, parent):
    return [s for s in root.spans if s.parent == parent.id]


def _named(root, name):
    return [s for s in root.spans if s.name == name]


def test_off_a_span_is_one_shared_object_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)  # the spans' range (the optimizer opens its own)
    monkeypatch.setattr(TRACER, "open", refuse)
    TRACER.clear()
    assert span("sample.step", i=0) is span("train.step")
    with span("sample.step", i=0) as got:
        assert got is None
    diff = _diffusion()
    _sample(diff)
    _train(diff)
    assert TRACER.roots() == []


def test_a_sampling_request_is_one_root_of_steps_guided_calls_and_layers():
    diff = _diffusion()
    TRACER.clear()
    with torch.profiler.profile(activities=CPU) as prof:
        _sample(diff)
    (root,) = TRACER.roots()
    assert root.record.name == "sample.request" and root.record.parent is None
    assert all(s.root == root.record.id for s in root.spans)
    steps = _children(root, root.record)
    assert [s.name for s in steps] == ["sample.cond"] + ["sample.step"] * STEPS
    assert [s.attrs["i"] for s in steps[1:]] == list(range(STEPS))
    for s in steps[1:]:
        (guided,) = _children(root, s)
        assert guided.name == "sample.guided"
        layers = [c for c in _children(root, guided) if c.name == "decoder.layer"]
        assert [c.attrs["i"] for c in layers] == list(range(CFG["num_layers"]))
        for layer in layers:  # the default serving kernels: K1, K7 over the hoisted k/v, K2
            assert [c.name for c in _children(root, layer)] == ["k1.sa_block", "k7.ca_block", "k2.ff_tail"]
        assert [c.name for c in _children(root, guided)][-1] == "sample.cfg"
    for s in root.spans:
        assert s.start_ns <= s.end_ns and s.events is None  # no card: host times only
    names = {e.name for e in prof.events()}
    assert {"tcd." + s.name for s in root.spans} <= names


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_is_one_root_of_its_phases_in_order(remat):
    diff = _diffusion(remat)
    TRACER.clear()
    with torch.profiler.profile(activities=CPU) as prof:
        _train(diff)
    (root,) = TRACER.roots()
    assert root.record.name == "train.step"
    assert [s.name for s in _children(root, root.record)] == PHASES
    (loss,), (backward,) = _named(root, "train.loss"), _named(root, "train.backward")
    layers = _children(root, loss)[0]
    assert layers.name == "decoder.layer"
    assert [s.name for s in _children(root, layers)] == ["k3.sa_block_train", "k4.ca_block_train",
                                                         "k5.ff_tail_train"]
    bwd = [s for s in root.spans if s.name.endswith(".bwd")]
    assert [s.name for s in bwd] == ["k5.ff_tail_train.bwd", "k4.ca_block_train.bwd",
                                     "k3.sa_block_train.bwd"] * CFG["num_layers"]
    assert all(s.parent == backward.id for s in bwd)
    recomputed = [s for s in root.spans if s.name == "k3.sa_block_train" and s.parent != layers.id
                  and s.start_ns > backward.start_ns]
    # under remat each layer's forward runs again inside the backward, in its first kernel's backward span
    assert len(recomputed) == (CFG["num_layers"] if remat else 0)
    by_id = {s.id: s for s in root.spans}
    for s in recomputed:
        assert by_id[s.parent].name == "k5.ff_tail_train.bwd"
    assert {"tcd." + s.name for s in root.spans} <= {e.name for e in prof.events()}


def test_a_span_first_opened_on_another_thread_nests_under_the_adopting_span():
    tracer, seen = Tracer(), {}
    monkey = pytest.MonkeyPatch()
    monkey.setattr(profiling, "TRACER", tracer)
    try:
        with torch.profiler.profile(activities=CPU):
            with span("train.step") as step, span("train.backward", adopt=True) as backward:
                t = threading.Thread(target=lambda: seen.update(rec=tracer.open("k5.ff_tail_train.bwd", {})))
                t.start()
                t.join()
                tracer.close(seen["rec"])
            with span("train.adan"):
                pass
    finally:
        monkey.undo()
    (root, other) = tracer.roots()
    assert seen["rec"].parent == backward.id and seen["rec"].root == step.id
    assert [s.name for s in root.spans] == ["train.step", "train.backward", "k5.ff_tail_train.bwd"]
    assert other.record.name == "train.adan" and other.record.parent is None  # nothing adopts once closed


def test_threads_opening_spans_at_once_lose_none():
    tracer, threads, roots = Tracer(keep=10_000), 16, 100

    def work(k: int):
        for i in range(roots):
            root = tracer.open("sample.request", {"k": k, "i": i})
            for j in range(3):
                tracer.close(tracer.open("sample.step", {"i": j}))
            tracer.close(root)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = tracer.roots()
    assert len(got) == threads * roots
    assert len({s.id for r in got for s in r.spans}) == 4 * threads * roots
    for r in got:
        assert [s.name for s in r.spans] == ["sample.request"] + ["sample.step"] * 3
        assert all(s.parent == r.record.id and s.root == r.record.id for s in r.spans[1:])


def test_the_tracer_keeps_its_last_roots():
    tracer = Tracer(keep=3)
    with torch.profiler.profile(activities=CPU):
        for i in range(5):
            rec = tracer.open("train.step", {"i": i})
            tracer.close(tracer.open("train.loss", {}))
            tracer.close(rec)
    assert [r.record.attrs["i"] for r in tracer.roots()] == [2, 3, 4]
    assert all(len(r.spans) == 2 for r in tracer.roots())


def test_data_parallel_steps_have_one_allreduce_span_each(tmp_path):
    ranks = tp.run_ranks("traced_train_steps", tmp_path, {"steps": 2})
    assert len(ranks) == tp.WORLD
    for got in ranks:
        assert got["phases"] == [PHASES[:2] + ["train.allreduce"] + PHASES[2:]] * 2
