"""The port's DBN trainer against the JAX package's, on the CPU in f32.

A tiny config (window 8, step 4, 2 blocks of 2 x 16, 438 music channels)
at dropout 0, the JAX params perturbed so that every leaf shows and
carried into the port by `traj_params_to_state_dict`. The port's step is
given the window start that JAX's step draws (recomputed here from its
`fold_in`/`split`).

Tolerances: each loss term 1e-5 relative; each gradient 1e-4 of its
tensor's largest value (f32 sums in another order through the LSTM's
recurrence and 2 blocks), but the attention's key biases, whose gradient
is zero in exact arithmetic: both packages' are rounding, held under 1e-6
of the network's largest gradient. AdamW's first steps move an element by about lr
x sign(g) whatever the gradient's size, so parameters are not compared
element by element: after two steps at most 5% of a tensor's elements may
differ by more than lr/10 (the rule `chip_smoke.py` uses for Adan).
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tcdiff_tpu.config import TrajDecoderConfig as JaxTrajConfig  # noqa: E402
from tcdiff_tpu.train.state import create_train_state as jax_create_state  # noqa: E402
from tcdiff_tpu.trajdecoder import trainer as jtrainer  # noqa: E402
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder  # noqa: E402
from tcdiff_torch.config import TrajDecoderConfig  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_traj_params, load_reference_traj, traj_params_to_state_dict  # noqa: E402,E501
from tcdiff_torch.trajdecoder import model as model_mod  # noqa: E402
from tcdiff_torch.trajdecoder.dataset import SyntheticTrajDataset  # noqa: E402
from tcdiff_torch.trajdecoder import trainer as trainer_mod  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.trajdecoder.trainer import (  # noqa: E402
    TrajTrainer, make_traj_optimizer, make_traj_train_step, traj_losses,
)

SMALL = dict(window_size=8, step=4, trans_layer=2, latent_dim=16, n_head=2, dropout=0.0, lr=1e-3,
             total_iter=4, print_iter=2, batch_size=8, lr_milestones=(1,), gamma=0.5, seed=0)
CFG, JCFG = TrajDecoderConfig(**SMALL), JaxTrajConfig(**SMALL)
B, DN, S = 4, 3, 20


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The metrics to JSONL alone: importing TensorBoard here pulls in
    TensorFlow (~14 s)."""
    monkeypatch.setattr(trainer_mod, "MetricLogger", functools.partial(
        trainer_mod.MetricLogger, use_wandb=False, use_tensorboard=False))


def test_traj_losses_match_jax():
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(2, 3, 10, 2)).astype(np.float32) for _ in range(2))
    total, parts = traj_losses(torch.from_numpy(pred), torch.from_numpy(target))
    jtotal, jparts = jtrainer.traj_losses(jnp.asarray(pred), jnp.asarray(target))
    for k in ("recon", "dis_loss", "v_loss"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    one, _ = traj_losses(torch.from_numpy(pred[:, :1]), torch.from_numpy(target[:, :1]))  # one dancer: no dis
    np.testing.assert_allclose(one.item(), float(jtrainer.traj_losses(jnp.asarray(pred[:, :1]),
                                                                      jnp.asarray(target[:, :1]))[0]), rtol=1e-6)


def test_lr_schedule_steps_at_its_milestone():
    cfg = TrajDecoderConfig(**{**SMALL, "lr": 2e-3, "lr_milestones": (3, 5), "gamma": 0.05})
    opt, sched = make_traj_optimizer(TrajDecoder(cfg, device="cpu"), cfg)
    ref = optax.piecewise_constant_schedule(cfg.lr, {m: cfg.gamma for m in cfg.lr_milestones})
    for count in range(8):  # the lr of update `count`, as the JAX optimizer's count sees it
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(ref(count)), rtol=1e-6, err_msg=str(count))
        opt.step()
        sched.step()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(B, DN, S, 3)) * 0.5).astype(np.float32)
    cond = rng.normal(size=(B, 2 * S + 1, CFG.cond_feature_dim)).astype(np.float32)
    jm = JaxTrajDecoder(JCFG)
    params = jm.init(jax.random.key(0), jnp.zeros((1, DN, CFG.window_size, 2)),
                     jnp.zeros((1, 2 * (CFG.window_size + CFG.step), CFG.cond_feature_dim)))["params"]
    prng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * prng.normal(size=p.shape).astype(np.float32), params)
    return jm, params, x, cond


def _jax_start(rng, step: int) -> int:
    """The window start JAX's train step draws at `step`."""
    win_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    return int(jax.random.randint(win_rng, (), 0, S - CFG.window_size - CFG.step))


def test_two_steps_match_make_traj_train_step(setup):
    jm, params, x, cond = setup
    tx = jtrainer.make_traj_optimizer(JCFG)
    jstate = jax_create_state(params, tx)
    jstep = jax.jit(jtrainer.make_traj_train_step(jm, tx, JCFG))
    model = load_jax_traj_params(TrajDecoder(CFG, device="cpu"), params)
    opt, sched = make_traj_optimizer(model, CFG)
    step = make_traj_train_step(model, opt, sched, CFG)
    rng = jax.random.key(3)
    w, sh = CFG.window_size, CFG.step
    xy, jcond = jnp.asarray(x)[..., :2], jnp.asarray(cond)
    slice_ = jax.lax.dynamic_slice_in_dim

    @jax.jit
    def jax_grads(p, start):
        """JAX's gradients at the window of `start`."""
        def loss_fn(p):
            pred = jm.apply({"params": p}, slice_(xy, start, w, 2), slice_(jcond, 2 * start, 2 * (w + sh), 1))
            return jtrainer.traj_losses(pred, slice_(xy, start + sh, w, 2))[0]
        return jax.grad(loss_fn)(p)

    for i in range(2):
        start = _jax_start(rng, i)
        jgrads = traj_params_to_state_dict(jax.tree.map(np.asarray, jax_grads(jstate.params, start)),
                                           CFG.trans_layer)
        jstate, jm_metrics = jstep(jstate, jnp.asarray(x), jcond, rng)
        m = step(torch.from_numpy(x), torch.from_numpy(cond), None, start=start)
        for k in ("recon", "dis_loss", "v_loss", "total"):
            np.testing.assert_allclose(m[k].item(), float(jm_metrics[k]), rtol=1e-5, err_msg=f"{i} {k}")
        largest = max(np.abs(g).max() for g in jgrads.values())
        for name, p in model.named_parameters():
            ref = jgrads[name]
            if name.endswith("attn.key.bias"):
                # zero in exact arithmetic (a shift of every key's logit
                # by q.b leaves the softmax as it is): both are rounding
                assert max(np.abs(ref).max(), p.grad.abs().max().item()) <= 1e-6 * largest, name
                continue
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f"{i} {name}")
    assert int(jstate.step) == 2 and sched.last_epoch == 2
    lr_now = CFG.lr * CFG.gamma  # the second update ran past the milestone
    ref = traj_params_to_state_dict(jax.tree.map(np.asarray, jstate.params), CFG.trans_layer)
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # AdamW moves it by about lr x the sign of its rounding-level gradient
        off = np.mean(np.abs(p.detach().numpy() - ref[name]) > lr_now / 10)
        assert off <= 0.05, (name, off)


def test_dropout_is_exactly_the_identity_at_rate_0_and_draws_from_the_generator(setup):
    jm, params, x, cond = setup
    model = load_jax_traj_params(TrajDecoder(CFG, device="cpu"), params)
    xs = torch.from_numpy(x[:, :, :CFG.window_size, :2])
    music = torch.from_numpy(cond[:, :2 * (CFG.window_size + CFG.step)])
    assert torch.equal(model.forward_train(xs, music), model(xs, music))

    model.cfg = TrajDecoderConfig(**{**SMALL, "dropout": 0.1})
    run = lambda seed: model.forward_train(xs, music, torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        model.forward_train(xs, music)  # dropout > 0 and no generator
    drop = model_mod.dropout_fn(0.1, torch.Generator().manual_seed(5))
    kept = (drop(torch.ones(200_000)) != 0).double().mean().item()
    assert abs(kept - 0.9) < 0.005
    masks = [model_mod.dropout_fn(0.1, torch.Generator().manual_seed(5))(torch.ones(1000)) for _ in range(2)]
    assert torch.equal(*masks)


def test_trainer_end_to_end_checkpoint_reloads(tmp_path):
    cfg = TrajDecoderConfig(**{**SMALL, "dropout": 0.1})
    trainer = TrajTrainer(cfg, dancer_num=2, device="cpu")
    train_ds = SyntheticTrajDataset(6, 2, seq_len=16, seed=0, device="cpu")
    test_ds = SyntheticTrajDataset(3, 2, seq_len=16, seed=1, normalizer=train_ds.normalizer, device="cpu")
    trainer.train(train_ds, test_ds, out_dir=str(tmp_path))  # batch 8 > 6 slices: clamped
    assert trainer.step == cfg.total_iter and len(trainer.losses) == 4 and np.isfinite(trainer.losses).all()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl") if "_config" not in line]
    assert len(rows) == 2 and rows[-1]["step"] == 4 and np.isfinite(rows[-1]["total"])
    assert [p.rsplit("/", 1)[-1] for p in trainer.checkpoints] == ["ckpt_2.pt", "ckpt_4.pt"]
    assert trainer.last_eval.shape[:2] == (3, 2) and trainer.last_eval.shape[2] >= cfg.window_size
    assert np.isfinite(trainer.last_eval).all()

    fresh = load_reference_traj(TrajDecoder(cfg, device="cpu"), trainer.checkpoints[-1])
    xs = torch.from_numpy(test_ds.roots[:2, :, :cfg.window_size, :2])
    music = torch.from_numpy(test_ds.music[:2, :2 * (cfg.window_size + cfg.step)])
    assert torch.equal(fresh(xs, music), trainer.model(xs, music))

    resumed = TrajTrainer(cfg, dancer_num=2, device="cpu")
    norm = resumed.restore(trainer.checkpoints[0])
    assert resumed.step == 2 and resumed.scheduler.last_epoch == 2
    assert torch.equal(norm.scale, train_ds.normalizer.scale)


def test_cli_synthetic_runs(tmp_path):
    from tcdiff_torch.cli.train_traj import main

    trainer = main(["--synthetic", "--synthetic_size", "4", "--seq_len", "16", "--window_size", "8", "--step", "4",
                    "--trans_layer", "1", "--total_iter", "2", "--print_iter", "1", "--batch_size", "4",
                    "--device", "cpu", "--out_dir", str(tmp_path), "--exp_name", "e"])
    assert trainer.step == 2 and (tmp_path / "e" / "ckpt" / "ckpt_2.pt").exists()
    again = main(["--synthetic", "--synthetic_size", "4", "--seq_len", "16", "--window_size", "8", "--step", "4",
                  "--trans_layer", "1", "--total_iter", "3", "--print_iter", "1", "--batch_size", "4",
                  "--device", "cpu", "--out_dir", str(tmp_path), "--exp_name", "e",
                  "--checkpoint", str(tmp_path / "e" / "ckpt" / "ckpt_2.pt")])
    assert again.step == 3 and len(again.losses) == 1  # resumed at step 2
