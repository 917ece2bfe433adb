"""The port's `python -m tcdiff_torch.cli.train` on the CPU: its flags
against the JAX package's (names, defaults, the config they fill), the
flags that raise, and the dispatch of all five modes with `--device cpu`
on synthetic data (the model shrunk to tests/_torch_tcdiff.py's tiny
configuration), each leaving its files; without `--device cpu` and with
no card it raises."""

import dataclasses
import functools
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_tcdiff import cfgs, orch  # noqa: E402
from tcdiff_tpu.cli import args as jargs  # noqa: E402
from tcdiff_torch.cli import args, train  # noqa: E402
from tcdiff_torch.data.audio import save_wav  # noqa: E402
from tcdiff_torch.data.features import SR  # noqa: E402
from tcdiff_torch.parallel.mesh import Rows, make_mesh  # noqa: E402
import torch.distributed as dist  # noqa: E402


def test_flags_and_defaults_match_jax():
    ours = vars(args.build_parser().parse_args([]))
    ref = vars(jargs.build_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == ref


def test_config_from_opt_matches_jax():
    argv = ["--required_dancer_num", "3", "--window_size", "32", "--batch_size", "5", "--learning-rate", "1e-4",
            "--epochs", "7", "--save_interval", "2", "--ema_interval", "3", "--seed", "4", "--compute_dtype",
            "bfloat16", "--data_path", "/d", "--processed_data_dir", "/p"]
    ours, ref = args.config_from_opt(args.parse_train_opt(argv)), jargs.config_from_opt(jargs.parse_train_opt(argv))
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(ref.model)
    for mine, theirs in ((ours.data, ref.data), (ours.train, ref.train)):  # the port keeps what it reads
        want = dataclasses.asdict(theirs)
        for k, v in dataclasses.asdict(mine).items():
            assert want[k] == v, k
    assert ours.data.data_path == "/d" and ours.data.processed_data_dir == "/p"
    assert ours.train.compute_dtype == "bfloat16" and ours.train.epochs == 7 and ours.train.save_interval == 2


@pytest.mark.parametrize("argv, item", [(["--dp", "2"], None), (["--tp", "2"], "item 9"),
                                        (["--scan_steps", "4"], "item 6"), (["--remat"], "item 8")])
def test_flags_that_raise(argv, item, monkeypatch):
    """--dp is accepted and must equal the world size: --dp 2 builds its
    mesh in a world of 2 (the group's size read from torch.distributed)
    and raises in a lone process; --scan_steps 4 raises
    NotImplementedError naming its ROADMAP item. --remat (item 8) and --tp
    (item 9) are ported: --remat fills cfg.train.remat and --tp
    cfg.train.tp, as the JAX package's; --tp 2 with dp 1 lays a world of 2
    out as one dp row of two tp ranks (rank 1: tp index 1), and a world
    the grid does not fill, or a tp that does not divide it, raises
    ValueError with the numbers."""
    if item == "item 8":
        opt = args.parse_train_opt(argv + ["--tp", "2"])
        assert args.config_from_opt(opt).train.remat and jargs.config_from_opt(opt).train.remat
        assert args.config_from_opt(opt).train.tp == jargs.config_from_opt(opt).train.tp == 2
        return
    if item == "item 9":
        opt = args.parse_train_opt(argv)
        assert args.config_from_opt(opt).train.tp == 2
        with pytest.raises(ValueError, match="dp=1 x tp=2 = 2 but the world has 1"):
            make_mesh(1, opt.tp, device="cpu")
        with pytest.raises(ValueError, match="tp=2 does not divide the world of 1"):
            make_mesh(-1, opt.tp, device="cpu")
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
        mesh = make_mesh(1, opt.tp, device="cpu")
        assert (mesh.rank, mesh.world, mesh.tp_rank, mesh.tp, mesh.group) == (0, 1, 1, 2, None)
        assert mesh.rows(4) == Rows(0, 4, 4) and not mesh.host0
        assert make_mesh(-1, 2, device="cpu").tp_rank == 1
        return
    if item is None:
        opt = args.parse_train_opt(argv)
        assert args.config_from_opt(opt).train.dp == 2
        with pytest.raises(ValueError, match="dp=2 but the world has 1"):
            make_mesh(opt.dp, opt.tp, device="cpu")
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
        mesh = make_mesh(opt.dp, opt.tp, device="cpu")
        assert (mesh.rank, mesh.world, mesh.rows(4)) == (1, 2, Rows(2, 4, 4))
        with pytest.raises(ValueError, match="dp=3 but the world has 2"):
            make_mesh(3, 1, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        args.parse_train_opt(argv)
    args.parse_train_opt(["--dp", "1"])  # one card is what -1 means here


@pytest.fixture
def tiny(monkeypatch):
    """config_from_opt's dancers and frames from the flags, the rest tiny."""
    _, small = cfgs()

    def config(opt):
        cfg = args.config_from_opt(opt)
        return dataclasses.replace(small, model=dataclasses.replace(small.model, dancer_num=cfg.model.dancer_num,
                                                                    seq_len=cfg.model.seq_len),
                                   train=cfg.train, data=cfg.data)

    monkeypatch.setattr(train, "config_from_opt", config)
    monkeypatch.setattr(orch, "MetricLogger", functools.partial(orch.MetricLogger, use_wandb=False,
                                                                use_tensorboard=False))


def _argv(tmp_path, mode, *extra):
    return ["--mode", mode, "--synthetic", "--synthetic_size", "8", "--device", "cpu", "--window_size", "16",
            "--required_dancer_num", "2", "--project", str(tmp_path / "runs"), "--exp_name", "t", "--render_dir",
            str(tmp_path / "renders"), "--vis_fk_out", str(tmp_path / "fk"), "--no_render", "--render_count", "2",
            "--epochs", "1", "--save_interval", "1", "--batch_size", "4", *extra]


def _wav(tmp_path) -> str:
    y = np.random.default_rng(0).normal(size=int(1.2 * SR)).astype(np.float32) * 0.1
    path = str(tmp_path / "my_song.wav")
    save_wav(path, y, SR)
    return path


def test_train_then_every_mode_from_its_checkpoint(tmp_path, tiny):
    runner = train.main(_argv(tmp_path, "train"))
    assert runner.state.step == 2 and not runner.use_ema_for_eval and runner.model.dtype == torch.float32
    ckpts = tmp_path / "runs" / "t" / "checkpoints"
    assert os.listdir(ckpts) == ["ckpt_2.pt"]
    again = train.main(_argv(tmp_path, "train"))  # a new run directory, t2
    assert again.state.step == 2 and os.path.isdir(tmp_path / "runs" / "t2" / "checkpoints")

    ck = ["--checkpoint", str(ckpts)]
    val = train.main(_argv(tmp_path, "val_without_TrajModel", *ck, "--sample_mode", "long"))
    assert val.use_ema_for_eval and val.state.step == 2
    assert sorted(os.listdir(tmp_path / "fk")) == ["1_synthetic_0.pkl"]  # the slices of synthetic_0
    train.main(_argv(tmp_path, "test", *ck))
    assert len(os.listdir(tmp_path / "fk")) == 3
    train.main(_argv(tmp_path, "eval", *ck, "--traj_source", "both"))
    with open(tmp_path / "runs" / "t" / "eval.json") as f:
        report = json.load(f)
    assert report["traj_source"] == "both" and np.isfinite(report["dbn_traj"]["fid_k"])
    wav = _wav(tmp_path)
    train.main(_argv(tmp_path, "generate", *ck, "--wav", wav))
    # 3 slices stitched (16 + 2 x 8 frames), named as the JAX package names
    # them: the stem without its last "_" part
    with open(tmp_path / "fk" / "gen_my.pkl", "rb") as f:
        assert pickle.load(f)["full_pose"].shape == (2, 32, 24, 3)
    train.main(_argv(tmp_path, "generate", *ck, "--wav", wav, "--streaming"))
    assert os.path.exists(tmp_path / "fk" / "stream_0_my_song.pkl")


def test_train_with_remat_matches_train_without(tmp_path, tiny):
    """`--remat` runs through the CLI: the model recomputes its layers, and
    the checkpoint equals the one without remat bit for bit."""
    plain = train.main(_argv(tmp_path, "train"))
    remat = train.main(_argv(tmp_path, "train", "--remat"))
    assert remat.model.remat and not plain.model.remat and remat.state.step == plain.state.step == 2
    for (name, p), q in zip(plain.model.named_parameters(), remat.model.parameters()):
        assert torch.equal(p, q), name


def test_generate_without_a_checkpoint_uses_the_synthetic_stats(tmp_path, tiny):
    runner = train.main(_argv(tmp_path, "generate", "--wav", _wav(tmp_path), "--compute_dtype", "bfloat16"))
    assert runner.normalizer is not None and runner.model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="--wav"):
        train.main(_argv(tmp_path, "generate"))


def test_without_a_card_it_raises(tmp_path, tiny):
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    argv = _argv(tmp_path, "eval")
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(argv)
