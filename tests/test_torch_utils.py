"""The port's run-time helpers (`tcdiff_torch/utils/`) against the JAX
package's: run directories, the JSONL metrics, the step timer, the trace,
and the checkpoints' file naming and DBN layout."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tcdiff_tpu.utils import logging as jlogging  # noqa: E402
from tcdiff_tpu.utils import paths as jpaths  # noqa: E402
from tcdiff_tpu.utils import profiling as jprofiling  # noqa: E402
from tcdiff_torch.config import TrajDecoderConfig  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402
from tcdiff_torch.interop.from_jax import load_reference_traj  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.trajdecoder.trainer import make_traj_optimizer  # noqa: E402
from tcdiff_torch.utils import checkpoint, logging, paths, profiling  # noqa: E402


@pytest.mark.parametrize("name, sep, existing", [("exp", "", []), ("exp", "", ["exp", "exp2", "exp7"]),
                                                 ("run.txt", "_", ["run.txt", "run_3.txt"])])
def test_increment_path_matches_jax(tmp_path, name, sep, existing):
    for i, e in enumerate(existing):
        (tmp_path / e).mkdir() if "." not in e else (tmp_path / e).write_text(str(i))
    mine = paths.increment_path(tmp_path / name, sep=sep)
    assert mine == jpaths.increment_path(tmp_path / name, sep=sep)
    assert paths.increment_path(tmp_path / name, exist_ok=True, sep=sep) == tmp_path / name


def test_metric_logger_rows_match_jax(tmp_path):
    rows = []
    for mod, d in ((logging, tmp_path / "torch"), (jlogging, tmp_path / "jax")):
        m = mod.MetricLogger(str(d), config={"lr": 1e-3}, use_wandb=False, use_tensorboard=False)
        m.log({"total": np.float32(0.5), "loss": torch.tensor(2.0), "note": "x"}, step=3)
        m.close()
        rows.append([json.loads(line) for line in open(d / "metrics.jsonl")])
    for a, b in zip(*rows):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "wall_s"} == {k: v for k, v in b.items() if k != "wall_s"}
    assert logging.get_logger(str(tmp_path / "log"), name="tcdiff_torch_test").handlers


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 1.0, 1.2, 2.0, 2.9]  # steps of 0.5, 0.2 / 2, 0.9 / 3 seconds
    out = []
    for mod in (profiling, jprofiling):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer = mod.StepTimer(smoothing=0.5)
        for steps in (1, 2, 3):
            timer.tick()
            timer.tock(steps)
        out.append(timer.metrics(motion_seconds_per_step=10.0))
    assert out[0] == out[1] and out[0]["step_time_s"] == pytest.approx(0.3)  # 0.5 (0.5 0.5 + 0.5 0.1) + 0.5 0.3


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]
    with profiling.trace(None):  # off: a no-op
        pass


def test_traj_checkpoint_layout_and_latest(tmp_path):
    cfg = TrajDecoderConfig(window_size=8, step=4, trans_layer=1, latent_dim=16, n_head=2)
    model = TrajDecoder(cfg, device="cpu").init_random(torch.Generator().manual_seed(0))
    opt, sched = make_traj_optimizer(model, cfg)
    norm = Normalizer.fit(np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32), device="cpu")
    for step in (2, 10, 4):
        checkpoint.save_traj_checkpoint(str(tmp_path), step, model, opt, sched, norm)
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt_10.pt")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    raw = torch.load(tmp_path / "ckpt_10.pt", weights_only=False)
    assert set(raw) == {"net", "optimizer", "scheduler", "step", "normalizer"} and raw["step"] == 10
    assert isinstance(raw["normalizer"]["scale"], np.ndarray)
    loaded = checkpoint.load_checkpoint(str(tmp_path / "ckpt_10.pt"), device="cpu")["normalizer"]
    assert torch.equal(loaded.scale, norm.scale) and torch.equal(loaded.offset, norm.offset)
    fresh = load_reference_traj(TrajDecoder(cfg, device="cpu"), str(tmp_path / "ckpt_10.pt"))
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
