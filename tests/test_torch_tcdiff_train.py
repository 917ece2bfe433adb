"""The port's `TCDiff` training and weights on the CPU: `train_loop` with
its checkpoints, metrics, renders and eval at every save interval, and a
resume from the run's checkpoint directory; the narrowed catch (only the
drawing and writing of the render is caught); a dancer-count mismatch;
a reference `.pt`; the EMA swapped in for sampling; and the weights'
round trip port -> flax (the JAX package's `dance_decoder_params_from_torch`)
-> port, bit for bit. Tiny configuration of tests/_torch_tcdiff.py."""

import dataclasses
import functools
import json
import logging
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_tcdiff import NF, cfgs, orch, parsed_opt  # noqa: E402
from tcdiff_tpu.interop import dance_decoder_params_from_torch  # noqa: E402
from tcdiff_torch.config import DataConfig  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from tcdiff_torch.utils.logging import MetricLogger  # noqa: E402


def _runner(checkpoint_path=None, **train):
    """The tiny TCDiff, its cfg.train's counts replaced by `train`."""
    _, pc = cfgs()
    return orch.TCDiff(dataclasses.replace(pc, train=dataclasses.replace(pc.train, **train)),
                       checkpoint_path=checkpoint_path, use_ema_for_eval=False, device="cpu")


def _train_opt(tmp_path, **kw):
    return parsed_opt(**{**dict(project=str(tmp_path / "runs"), exp_name="t", render_dir=str(tmp_path / "renders"),
                                synthetic=True, synthetic_size=8, render_count=2, eval_during_train=True), **kw})


@pytest.fixture(autouse=True)
def jsonl_only(monkeypatch):
    monkeypatch.setattr(orch, "MetricLogger", functools.partial(orch.MetricLogger, use_wandb=False,
                                                                use_tensorboard=False))


def test_train_checkpoints_metrics_renders_and_resume(tmp_path):
    runner = _runner(epochs=3, save_interval=2)
    out = runner.train_loop(_train_opt(tmp_path))
    assert out["steps"] == 6 and runner.state.step == 6 and len(out["checkpoints"]) == 1
    rows = [json.loads(line) for line in open(tmp_path / "runs" / "t" / "metrics.jsonl") if "_config" not in line]
    evals = [r for r in rows if "eval/fid_k" in r]
    assert len(rows) == 2 and len(evals) == 1 and np.isfinite(evals[0]["eval/fid_g"]) and evals[0]["step"] == 4
    assert sorted(os.listdir(tmp_path / "renders")) == [f"e2_b{b}_synthetic_{b}_slice0.gif" for b in (0, 1)]
    assert os.path.exists(tmp_path / "runs" / "t" / "eval.json")

    # resume from the run's checkpoint directory (its step-4 state), then on
    ckpt = orch.latest_checkpoint(str(tmp_path / "runs" / "t" / "checkpoints"))
    saved = torch.load(ckpt, weights_only=False)
    resumed = _runner(str(tmp_path / "runs" / "t" / "checkpoints"), epochs=1)
    assert resumed.state.step == 4 and resumed.normalizer is not None
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p, saved["model_state_dict"][name])
        assert torch.equal(resumed.state.ema_params[name], saved["ema_state_dict"][name])
    more = resumed.train_loop(_train_opt(tmp_path, exp_name="t2", render=False, eval_during_train=False))
    assert more["steps"] == 2 and resumed.state.step == 6


def test_train_logs_to_the_wandb_project_of_the_flag(tmp_path, monkeypatch):
    """--wandb_pj_name reaches wandb.init as the project, with the JAX
    package's config {"lr", "batch"}; the metrics are logged there too."""
    runs = []

    class Run:
        def __init__(self, project, config):
            self.project, self.config, self.logged, self.finished = project, config, [], False
            runs.append(self)

        def log(self, metrics, step):
            self.logged.append((step, dict(metrics)))

        def finish(self):
            self.finished = True

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=lambda project, config: Run(project, config)))
    monkeypatch.setattr(orch, "MetricLogger", functools.partial(MetricLogger, use_tensorboard=False))
    runner = _runner(epochs=1, save_interval=1)
    runner.train_loop(_train_opt(tmp_path, wandb_pj_name="my_project", render=False, eval_during_train=False))
    _, pc = cfgs()
    assert len(runs) == 1 and runs[0].project == "my_project" and runs[0].finished
    assert runs[0].config == {"lr": pc.train.learning_rate, "batch": pc.train.batch_size}
    assert [step for step, _ in runs[0].logged] == [2] and np.isfinite(runs[0].logged[0][1]["total"])


def test_train_catches_only_the_render(tmp_path, monkeypatch, caplog):
    """A failed drawing or file write is logged and training goes on; a
    failure of the sampling or of the metrics ends the run."""
    runner = _runner(epochs=1)

    def broken_write(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(orch, "write_sample", broken_write)
    with caplog.at_level(logging.WARNING, logger="tcdiff_torch"):
        out = runner.train_loop(_train_opt(tmp_path, eval_during_train=False))
    assert out["steps"] == 2 and "render failed: disk full" in caplog.text

    def broken_sample(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(runner, "_sample", broken_sample)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        runner.train_loop(_train_opt(tmp_path, exp_name="t2", eval_during_train=False))
    monkeypatch.setattr(runner, "_sample", orch.TCDiff._sample.__get__(runner))
    monkeypatch.setattr(orch, "evaluate", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        runner.train_loop(_train_opt(tmp_path, exp_name="t3", render=False))


def test_dancer_count_mismatch_raises(tmp_path):
    _, pc = cfgs()
    two = orch.TCDiff(pc, device="cpu")
    ckpt = save_checkpoint(str(tmp_path / "c"), 0, two.state, None)
    ref = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": two.model.state_dict(), "ema_state_dict": two.model.state_dict()}, ref)
    for path in (ckpt, ref):
        with pytest.raises(ValueError, match="trained for 2 dancers but this run is configured for 3"):
            orch.TCDiff(pc.with_dancers(3), checkpoint_path=path, device="cpu")


def test_reference_checkpoint_loads_ema_or_trained_weights(tmp_path):
    _, pc = cfgs()
    src = orch.TCDiff(pc, device="cpu")
    trained = {k: v.clone() for k, v in src.model.state_dict().items()}
    ema = {k: v + 1.0 if v.is_floating_point() else v for k, v in trained.items()}
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": {"module." + k: v for k, v in trained.items()}, "ema_state_dict": ema,
                "normalizer": {"scale": np.full(NF, 2.0, np.float32), "offset": np.zeros(NF, np.float32)}}, path)
    for use_ema, want in ((True, ema), (False, trained)):
        r = orch.TCDiff(pc, checkpoint_path=path, use_ema_for_eval=use_ema, device="cpu")
        for name, p in r.model.named_parameters():
            assert torch.equal(p, want[name]) and torch.equal(r.state.ema_params[name], want[name])
        assert torch.equal(r.normalizer.scale, torch.full((NF,), 2.0))


def test_eval_weights_swap_in_the_ema_and_back():
    _, pc = cfgs()
    r = orch.TCDiff(pc, device="cpu")
    kept = {n: p.detach().clone() for n, p in r.model.named_parameters()}
    for t in r.state.ema_params.values():
        t.add_(1.0)
    with r.eval_weights():
        assert all(torch.equal(p, r.state.ema_params[n]) for n, p in r.model.named_parameters())
    assert all(torch.equal(p, kept[n]) for n, p in r.model.named_parameters())


def test_weights_round_trip_through_flax_bit_for_bit():
    """port -> the JAX package's `dance_decoder_params_from_torch` -> port."""
    _, pc = cfgs()
    m = dataclasses.replace(pc.model, num_layers=2)
    a = DanceDecoder(m, device="cpu").init_random(torch.Generator().manual_seed(4))
    params = dance_decoder_params_from_torch({k: v.numpy() for k, v in a.state_dict().items()}, num_layers=2)
    b = load_jax_params(DanceDecoder(m, device="cpu"), params)
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_load_datasets_reads_the_config_paths(monkeypatch):
    """The data paths come from cfg.data, whatever the flags say."""
    _, pc = cfgs()
    r = orch.TCDiff(dataclasses.replace(pc, data=DataConfig(data_path="/d", processed_data_dir="/p")), device="cpu")
    seen = {}
    monkeypatch.setattr(orch, "load_datasets", lambda opt, **kw: seen.update(vars(opt), **kw))
    r.load_datasets(parsed_opt(data_path="/flag", processed_data_dir="/flag"))
    assert seen["data_path"] == "/d" and seen["processed_data_dir"] == "/p" and seen["dancer_num"] == 2
