"""The port's `TCDiff.evaluate_loop` (`--mode eval`, trajectory source gt,
dbn and both) against the JAX package's, on the CPU, on the set-up of
tests/_torch_tcdiff.py; the reports within 1e-5 relative. And the DBN
checkpoints `TCDiff` reads, and the multi-GPU settings that raise."""

import dataclasses
import json
import logging
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_tcdiff import build_stack, cfgs, loop_opt, orch  # noqa: E402
from tcdiff_torch.cli.args import config_from_opt, parse_train_opt  # noqa: E402
from tcdiff_torch.config import TrainConfig  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.utils.checkpoint import save_traj_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    return build_stack(tmp_path_factory.mktemp("dbn"))


@pytest.mark.parametrize("source", ["gt", "dbn", "both"])
def test_eval_matches_jax(stack, tmp_path, source):
    jr, pr, jds, pds, pt = stack
    want = jr.evaluate_loop(loop_opt(tmp_path, "jax", traj_source=source, render_count=6), test_ds=jds)
    got = pr.evaluate_loop(loop_opt(tmp_path, "port", traj_source=source, render_count=6, traj_checkpoint=pt),
                           test_ds=pds)
    with open(tmp_path / "port" / "runs" / "e" / "eval.json") as f:
        assert json.load(f) == got

    def same(a, b):
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, dict):
                same(a[k], v)
            elif isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-9, err_msg=k)
            else:
                assert a[k] == v

    same(got, want)
    assert got["traj_source"] == source and ("dbn_traj" in got) == (source == "both")
    if source == "both":
        assert got["dbn_traj"]["fid_k"] != got["fid_k"]
    with pytest.raises(ValueError, match="traj_source"):
        pr.evaluate_loop(loop_opt(tmp_path, "port", traj_source="other"), test_ds=pds)


def test_traj_checkpoints(tmp_path, stack, caplog):
    """A reference `.pt`, the DBN trainer's checkpoint directory (its
    latest), and a JAX package's checkpoint directory, which raises."""
    _, pr, _, _, pt = stack
    model = lambda: TrajDecoder(pr.cfg.traj, device="cpu")
    ref = pr._load_traj_params(types.SimpleNamespace(traj_checkpoint=pt), model())
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    save_traj_checkpoint(str(tmp_path / "ckpt"), 8, ref, opt, torch.optim.lr_scheduler.StepLR(opt, 1), None)
    again = pr._load_traj_params(types.SimpleNamespace(traj_checkpoint=str(tmp_path / "ckpt")), model())
    assert all(torch.equal(a, b) for a, b in zip(ref.state_dict().values(), again.state_dict().values()))
    os.makedirs(tmp_path / "flax" / "ckpt_3")
    for path in (str(tmp_path / "flax"), str(tmp_path / "flax" / "ckpt_3")):
        with pytest.raises(ValueError, match="flax"):
            pr._load_traj_params(types.SimpleNamespace(traj_checkpoint=path), model())
    with caplog.at_level(logging.WARNING, logger="tcdiff_torch"):
        pr._load_traj_params(types.SimpleNamespace(traj_checkpoint=None), model())
    assert "random DBN weights" in caplog.text


def test_multi_gpu_settings_raise():
    """The multi-GPU settings enter through the flags of cli.train: --dp
    and --tp go into cfg.train.dp and cfg.train.tp (tensor parallelism,
    ROADMAP queue 1 item 9, is ported), and dp x tp must fill the world
    when TCDiff builds its mesh, so in a lone process --dp 2, --tp 2 and
    --dp 4 --tp 2 raise ValueError with the numbers."""
    cfg = config_from_opt(parse_train_opt(["--dp", "2"]))
    assert cfg.train.dp == 2 and TrainConfig().dp == -1 and TrainConfig().tp == 1
    assert config_from_opt(parse_train_opt(["--dp", "4", "--tp", "2"])).train.tp == 2
    small = cfgs()[1]
    for dp, tp, msg in ((2, 1, "dp=2 but the world has 1"), (-1, 2, "tp=2 does not divide the world of 1"),
                        (4, 2, "dp=4 x tp=2 = 8 but the world has 1")):
        with pytest.raises(ValueError, match=msg):
            orch.TCDiff(dataclasses.replace(small, train=dataclasses.replace(small.train, dp=dp, tp=tp)),
                        device="cpu")
    assert orch.TCDiff(small, device="cpu").mesh.world == 1
