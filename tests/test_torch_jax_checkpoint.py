"""`tools/jax_checkpoint_to_torch.py`: a checkpoint the JAX package wrote
(orbax, `tcdiff_tpu.utils.checkpoint.save_checkpoint`) converted into the
port's layout, restored by the port's trainers, and trained on.

The denoiser: test_torch_train.py's config (1 layer, d=64, 4 heads x 64,
seq 12 x 2 dancers, dropout 0), one step of the JAX package's
`make_train_step` with Adan (lr 1e-3, weight decay 0.02) and EMA 0.9,
saved with a normalizer. After the conversion and `restore_train_state`:
the parameters, the EMA, Adan's moments and count, the step and the
normalizer bit for bit; one forward within 1e-5; the next train step (the
port fed the t, noise and keep mask JAX's step draws) within
test_torch_train.py's whole-step tolerance, 3e-4, for the metrics and for
Adan's moments after it (m, v and n are the step's gradients and
prev_grad's linear and squared terms; the parameters themselves are not
compared after an Adan step that moves them, as that test explains).

The DBN: test_torch_traj_trainer.py's config (2 blocks of 2 x 16, dropout
0, lr 1e-3 halved at update 1), one step of the JAX package's
`make_traj_train_step`, saved. After the conversion and
`TrajTrainer.restore`: the network, AdamW's moments and count, the
schedule and the step exact; one forward within 1e-5; the next step (the
window start JAX draws) within that test's rules: the metrics 1e-5
relative and at most 5% of a tensor's elements more than lr/10 apart.
"""

import argparse
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.config import TrajDecoderConfig as JaxTrajConfig  # noqa: E402
from tcdiff_tpu.data.normalizer import Normalizer as JaxNormalizer  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.optim import adan as jax_adan  # noqa: E402
from tcdiff_tpu.train import create_train_state as jax_create_state  # noqa: E402
from tcdiff_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from tcdiff_tpu.trajdecoder import trainer as jtrainer  # noqa: E402
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder  # noqa: E402
from tcdiff_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from tcdiff_torch.config import (  # noqa: E402
    DanceDecoderConfig, DiffusionConfig, TCDiffConfig, TrainConfig, TrajDecoderConfig,
)
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import params_to_state_dict, traj_params_to_state_dict  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train import orchestrator as orch  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.trajdecoder.trainer import TrajTrainer  # noqa: E402
from tcdiff_torch.utils.checkpoint import restore_train_state  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch", pathlib.Path(__file__).parents[1] / "tools" / "jax_checkpoint_to_torch.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

CFG_KW = dict(nfeats=151, seq_len=12, latent_dim=64, ff_size=64, num_layers=1, num_heads=4,
              dropout=0.0, cond_feature_dim=16, dancer_num=2)
MCFG, JMCFG = DanceDecoderConfig(**CFG_KW), JaxDecoderConfig(**CFG_KW)
BS = 4
TRAJ = dict(window_size=8, step=4, trans_layer=2, latent_dim=16, n_head=2, dropout=0.0, lr=1e-3,
            lr_milestones=(1,), gamma=0.5, seed=0)
TCFG, JTCFG = TrajDecoderConfig(**TRAJ), JaxTrajConfig(**TRAJ)
S = 20


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def _equal_by_name(named, ref: dict) -> None:
    for name, t in named:
        np.testing.assert_array_equal(t.detach().numpy(), ref[name], err_msg=name)


def test_denoiser_checkpoint_restores_and_trains_on(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(BS, MCFG.dancer_num, MCFG.seq_len, 151)) * 0.3).astype(np.float32)
    x[..., :4] = rng.uniform(0.5, 1.5, size=x[..., :4].shape).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * MCFG.seq_len + 1, 16)).astype(np.float32)
    norm = {"scale": rng.uniform(0.5, 2.0, 151).astype(np.float32), "offset": rng.normal(size=151).astype(np.float32)}
    jmodel = JaxDecoder(JMCFG)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, MCFG.tokens, 151)),
                                             jnp.zeros((1, 2 * MCFG.seq_len + 1, 16)),
                                             jnp.zeros((1,), jnp.int32))["params"], 9)
    jd = JaxDiffusion(jmodel, JaxDiffusionConfig())
    tx = jax_adan(1e-3, weight_decay=0.02)
    jstep = jax.jit(jax_make_train_step(jd, tx, ema_beta=0.9, ema_interval=1))
    key = jax.random.key(5)
    jstate, _ = jstep(jax_create_state(params, tx), jnp.asarray(x), jnp.asarray(cond), key)
    src = jax_save_checkpoint(str(tmp_path / "jax"), 1, jstate, JaxNormalizer.from_torch_state(**{
        "scale_": norm["scale"], "min_": norm["offset"]}))
    with pytest.raises(FileNotFoundError, match="tools/jax_checkpoint_to_torch.py"):
        orch.TCDiff(TCDiffConfig(model=MCFG), checkpoint_path=src, device="cpu")
    assert tool.main([src, str(tmp_path / "port"), "--num_heads", "4", "--learning-rate", "1e-3"]) == 0

    model = DanceDecoder(MCFG, device="cpu")
    opt = Adan(model.parameters(), lr=1e-3, weight_decay=TrainConfig().weight_decay)
    state, normalizer = restore_train_state(str(tmp_path / "port" / "ckpt_1.pt"), create_train_state(model, opt))
    by_name = lambda tree: params_to_state_dict(jax.tree.map(np.asarray, tree), 1, MCFG.latent_dim)
    _equal_by_name(model.named_parameters(), by_name(jstate.params))
    _equal_by_name(state.ema_params.items(), by_name(jstate.ema_params))
    for k in ("m", "v", "n", "prev_grad"):
        _equal_by_name(((n, opt.state[p][k]) for n, p in model.named_parameters()),
                       by_name(getattr(jstate.opt_state, k)))
    assert state.step == int(jstate.step) == 1 and opt.param_groups[0]["step"] == int(jstate.opt_state.count) == 1
    assert opt.param_groups[0]["lr"] == 1e-3
    np.testing.assert_array_equal(normalizer.scale.numpy(), norm["scale"])
    np.testing.assert_array_equal(normalizer.offset.numpy(), norm["offset"])

    xt = x.transpose(0, 2, 1, 3).reshape(BS, MCFG.tokens, 151)
    t, keep = np.array([3, 40, 7, 20], np.int32), np.array([True, False, True, True])
    ref = np.asarray(jax.jit(jmodel.apply)({"params": jstate.params}, jnp.asarray(xt), jnp.asarray(cond),
                                           jnp.asarray(t), jnp.asarray(keep)))
    with torch.no_grad():
        out = model(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(keep))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    # the next step: the draws of JAX's step 1 (train_step.py, gaussian.py::loss/p_losses)
    k_t, k_rest = jax.random.split(jax.random.fold_in(key, 1))
    t = jax.random.randint(k_t, (BS,), 0, JaxDiffusionConfig().n_timestep)
    k_noise, k_keep, _ = jax.random.split(k_rest, 3)
    noise = jax.random.normal(k_noise, (BS, MCFG.seq_len, MCFG.dancer_num, 151), jnp.float32)
    keep = jax.random.bernoulli(k_keep, 1.0 - JaxDiffusionConfig().cond_drop_prob, (BS,))
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(cond), key)
    step = make_train_step(GaussianDiffusion(model, DiffusionConfig(), device="cpu"), opt, ema_beta=0.9,
                           device="cpu")
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(cond), t=torch.from_numpy(np.array(t)),
                    noise=torch.from_numpy(np.array(noise)), keep_mask=torch.from_numpy(np.array(keep)))
    for k in ("recon", "velocity", "fk", "foot", "total", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=3e-4, rtol=3e-4, err_msg=k)
    for k in ("m", "v", "n", "prev_grad"):
        ref = by_name(getattr(jstate.opt_state, k))
        for name, p in model.named_parameters():
            want = ref[name]
            np.testing.assert_allclose(opt.state[p][k].numpy(), want, rtol=3e-4,
                                       atol=3e-4 * max(np.abs(want).max(), 1e-30), err_msg=f"{k} {name}")
    assert state.step == int(jstate.step) == 2


def test_dbn_checkpoint_restores_and_trains_on(tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(BS, 3, S, 3)) * 0.5).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * S + 1, TCFG.cond_feature_dim)).astype(np.float32)
    jm = JaxTrajDecoder(JTCFG)
    params = _perturbed(jm.init(jax.random.key(0), jnp.zeros((1, 3, TCFG.window_size, 2)),
                                jnp.zeros((1, 2 * (TCFG.window_size + TCFG.step), TCFG.cond_feature_dim)))["params"], 7)
    tx = jtrainer.make_traj_optimizer(JTCFG)
    jstep = jax.jit(jtrainer.make_traj_train_step(jm, tx, JTCFG))
    key = jax.random.key(3)
    jstate, _ = jstep(jax_create_state(params, tx), jnp.asarray(x), jnp.asarray(cond), key)
    src = jax_save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    runner = orch.TCDiff(TCDiffConfig(model=MCFG, traj=TCFG), device="cpu")
    for given in (src, str(tmp_path / "jax")):  # the checkpoint, or the directory of checkpoints
        with pytest.raises(ValueError, match="tools/jax_checkpoint_to_torch.py"):
            runner._load_traj_params(argparse.Namespace(traj_checkpoint=given), TrajDecoder(TCFG, device="cpu"))
    path = tool.convert(src, str(tmp_path / "port"), traj=TCFG)

    trainer = TrajTrainer(TCFG, dancer_num=3, device="cpu")
    assert trainer.restore(path) is None and trainer.step == 1
    by_name = lambda tree: traj_params_to_state_dict(jax.tree.map(np.asarray, tree), TCFG.trans_layer)
    adam = jstate.opt_state[0]
    _equal_by_name(trainer.model.named_parameters(), by_name(jstate.params))
    for k, ref in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _equal_by_name(((n, trainer.optimizer.state[p][k]) for n, p in trainer.model.named_parameters()),
                       by_name(ref))
    assert all(int(s["step"]) == int(adam.count) == 1 for s in trainer.optimizer.state.values())
    assert trainer.scheduler.last_epoch == 1 and trainer.optimizer.param_groups[0]["lr"] == TCFG.lr * TCFG.gamma

    xs, music = x[:, :, :TCFG.window_size, :2], cond[:, :2 * (TCFG.window_size + TCFG.step)]
    ref = np.asarray(jax.jit(jm.apply)({"params": jstate.params}, jnp.asarray(xs), jnp.asarray(music)))
    with torch.no_grad():
        out = trainer.model(torch.from_numpy(xs), torch.from_numpy(music))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    win_rng, _ = jax.random.split(jax.random.fold_in(key, 1))
    start = int(jax.random.randint(win_rng, (), 0, S - TCFG.window_size - TCFG.step))
    jstate, jmetrics = jstep(jstate, jnp.asarray(x), jnp.asarray(cond), key)
    m = trainer._step_fn(torch.from_numpy(x), torch.from_numpy(cond), None, start=start)
    for k in ("recon", "dis_loss", "v_loss", "total"):
        np.testing.assert_allclose(m[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    lr_now = TCFG.lr * TCFG.gamma
    ref = by_name(jstate.params)
    for name, p in trainer.model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # AdamW moves it by about lr x the sign of its rounding-level gradient
        assert np.mean(np.abs(p.detach().numpy() - ref[name]) > lr_now / 10) <= 0.05, name
