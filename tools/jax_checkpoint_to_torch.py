"""Convert a checkpoint of the JAX package into the PyTorch port's layout.

    python tools/jax_checkpoint_to_torch.py SRC OUT_DIR [--num_heads 8] [--learning-rate 5e-5]

SRC is one `ckpt_{step}` directory that `tcdiff_tpu.utils.checkpoint.
save_checkpoint` wrote (orbax), of the denoiser's trainer or of the DBN's
(told apart by the DBN's LSTM); OUT_DIR receives `ckpt_{step}.pt` in the
layout the port's trainers write and read:

  * the denoiser (`tcdiff_torch.utils.checkpoint.save_checkpoint`, read by
    `restore_train_state` and `cli.train --checkpoint`): the parameters
    and the EMA through `interop.from_jax.params_to_state_dict`; Adan's
    `count, m, v, n, prev_grad` onto the port Adan's per-parameter
    `{m, v, n, prev_grad}` and its group's `step`, each moment tree through
    the same linear map as the parameters (so the transposes and the cond
    encoder's q/k/v concatenation follow); the normalizer and the step;
  * the DBN (`save_traj_checkpoint`, read by `TrajTrainer.restore` and
    `cli.train --traj_checkpoint`): the network through
    `traj_params_to_state_dict`; optax.adamw's `mu`, `nu` and `count` onto
    AdamW's `exp_avg`, `exp_avg_sq` and `step`; MultiStepLR at that count;
    the normalizer and the step.

The shapes (layers, widths, dancers, frames) are read from the parameters.
The head count is not in them and is only the model's to use, so it is
taken from --num_heads. The optimizers' hyperparameters are not in a JAX
checkpoint either: the denoiser's Adan takes --learning-rate and
`TrainConfig`'s betas, eps and weight decay, the DBN's AdamW and schedule
`TrajDecoderConfig`'s (as `cli.train_traj` builds them); a resumed run
takes the hyperparameters a checkpoint holds.

The plain-dict restore keeps every name this needs (the JAX package saves
its state through `flax.serialization.to_state_dict`, so optax's named
tuples are string-keyed dicts), so no target tree is built. Runs on the
CPU where JAX, flax and orbax are installed, which the port itself does
not need.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcdiff_torch.config import DanceDecoderConfig, TrainConfig, TrajDecoderConfig  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402
from tcdiff_torch.interop.from_jax import (  # noqa: E402
    load_jax_params, load_jax_traj_params, params_to_state_dict, traj_params_to_state_dict,
)
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: E402
from tcdiff_torch.trajdecoder.trainer import make_traj_optimizer  # noqa: E402
from tcdiff_torch.utils.checkpoint import save_checkpoint, save_traj_checkpoint  # noqa: E402


def decoder_config(params, num_heads: int = 8) -> DanceDecoderConfig:
    """The DanceDecoderConfig whose parameters have the shapes of `params`
    (a flax tree); `num_heads` splits the attention width."""
    d = params["input_projection"]["kernel"].shape[1]
    hd = params["embeddings_table"].shape[1]
    if hd % num_heads:
        raise ValueError(f"attention width {hd} does not split into {num_heads} heads")
    return DanceDecoderConfig(
        nfeats=params["input_projection"]["kernel"].shape[0],
        seq_len=params["null_cond_embed"].shape[1],
        latent_dim=d,
        ff_size=params["decoder_0"]["linear1"]["kernel"].shape[1],
        num_layers=sum(k.startswith("decoder_") for k in params),
        num_heads=num_heads,
        cond_feature_dim=params["cond_projection_0"]["kernel"].shape[1],
        dancer_num=params["relative_projection_0"]["kernel"].shape[0] // d,
        max_dancers=params["embeddings_table"].shape[0],
        head_dim=hd // num_heads,
    )


def traj_config(params, base: TrajDecoderConfig = TrajDecoderConfig()) -> TrajDecoderConfig:
    """`base` with the DBN's shapes read from `params` (a flax tree)."""
    return dataclasses.replace(
        base,
        nfeats=params["lstm"]["weight_ih_l0"].shape[1],
        latent_dim=params["cond_emb"]["kernel"].shape[0],
        cond_feature_dim=params["music_projection_0"]["kernel"].shape[1],
        trans_layer=sum(k.startswith("block_") for k in params),
    )


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _normalizer(payload) -> Optional[Normalizer]:
    norm = payload.get("normalizer")
    if norm is None:
        return None
    arrays = norm.to_numpy()
    return Normalizer.from_torch_state(arrays["scale"], arrays["offset"], device="cpu")


def convert_denoiser(payload, out_dir: str, num_heads: int = 8, train: TrainConfig = TrainConfig()) -> str:
    """A restored JAX denoiser checkpoint (`load_checkpoint`'s dict) ->
    `{out_dir}/ckpt_{step}.pt`; returns its path."""
    st = payload["state"]
    cfg = decoder_config(st["params"], num_heads)
    model = load_jax_params(DanceDecoder(cfg, device="cpu"), st["params"])
    opt = Adan(model.parameters(), lr=train.learning_rate, betas=train.adan_betas, eps=train.adan_eps,
               weight_decay=train.weight_decay)
    state = create_train_state(model, opt)
    by_name = lambda tree: params_to_state_dict(tree, cfg.num_layers, cfg.latent_dim)
    ema = by_name(st["ema_params"])
    adan = st["opt_state"]
    moments = {k: by_name(adan[k]) for k in ("m", "v", "n", "prev_grad")}
    for name, p in model.named_parameters():
        state.ema_params[name].copy_(_t(ema[name]))
        opt.state[p] = {k: _t(moments[k][name]) for k in ("m", "v", "n", "prev_grad")}
    opt.param_groups[0]["step"] = int(adan["count"])
    state.step = int(st["step"])
    return save_checkpoint(out_dir, state.step, state, _normalizer(payload))


def convert_dbn(payload, out_dir: str, base: TrajDecoderConfig = TrajDecoderConfig()) -> str:
    """A restored JAX DBN checkpoint -> `{out_dir}/ckpt_{step}.pt`; returns
    its path."""
    st = payload["state"]
    cfg = traj_config(st["params"], base)
    model = load_jax_traj_params(TrajDecoder(cfg, device="cpu"), st["params"])
    optimizer, scheduler = make_traj_optimizer(model, cfg)
    adam, schedule = st["opt_state"]["0"], st["opt_state"]["2"]  # optax.adamw: (adam, decay, lr schedule)
    count = int(adam["count"])
    mu, nu = (traj_params_to_state_dict(adam[k], cfg.trans_layer) for k in ("mu", "nu"))
    for name, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": _t(mu[name]),
                              "exp_avg_sq": _t(nu[name])}
    # MultiStepLR after `count` updates: optax's piecewise-constant lr at that count
    n_sched = int(schedule["count"])
    lr = cfg.lr * cfg.gamma ** sum(n_sched >= m for m in cfg.lr_milestones)
    for group in optimizer.param_groups:
        group["lr"] = lr
    scheduler.load_state_dict({**scheduler.state_dict(), "last_epoch": n_sched, "_step_count": n_sched + 1,
                               "_last_lr": [lr] * len(optimizer.param_groups)})
    return save_traj_checkpoint(out_dir, int(st["step"]), model, optimizer, scheduler, _normalizer(payload))


def convert(src: str, out_dir: str, num_heads: int = 8, train: TrainConfig = TrainConfig(),
            traj: TrajDecoderConfig = TrajDecoderConfig()) -> str:
    """Read the JAX checkpoint directory `src` and write the port's
    checkpoint of the same trainer under `out_dir`; returns its path."""
    from tcdiff_tpu.utils.checkpoint import load_checkpoint

    payload = load_checkpoint(src)
    if "lstm" in payload["state"]["params"]:
        return convert_dbn(payload, out_dir, traj)
    return convert_denoiser(payload, out_dir, num_heads, train)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="a ckpt_{step} directory of the JAX package")
    parser.add_argument("out_dir", help="where the port's ckpt_{step}.pt is written")
    parser.add_argument("--num_heads", type=int, default=DanceDecoderConfig.num_heads)
    parser.add_argument("--learning-rate", dest="learning_rate", type=float, default=TrainConfig.learning_rate,
                        help="the denoiser's Adan lr (the JAX checkpoint does not hold it)")
    opt = parser.parse_args(argv)
    train = dataclasses.replace(TrainConfig(), learning_rate=opt.learning_rate)
    print(convert(opt.src, opt.out_dir, opt.num_heads, train))
    return 0


if __name__ == "__main__":
    sys.exit(main())
