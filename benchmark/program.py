"""The measured program's entry points, as the cells drive them: the port's
denoiser built on the device from the benchmark's weights, its diffusion
and its train step. Only this module and the drivers import
`tcdiff_torch`."""

from __future__ import annotations

import torch

from benchmark.weights import make_weights

DIFFUSION_KEYS = ("n_timestep", "schedule", "predict_epsilon", "clip_denoised", "use_p2", "guidance_weight",
                  "cond_drop_prob", "sampling_timesteps", "ddim_eta", "w_recon", "w_velocity", "w_fk", "w_foot")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(model_cfg: dict, config: dict, seed: int, device, kernels=None):
    """(DanceDecoder in the configuration's precision holding the seed's
    weights, its GaussianDiffusion) on `device`."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, ServingKernels
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
    from tcdiff_torch.models.dance_decoder import DanceDecoder

    with torch.device(device):
        model = DanceDecoder(DanceDecoderConfig(**model_cfg), dtype=DTYPES[config["precision"]], device=device,
                             kernels=kernels or ServingKernels())
    missing, unexpected = model.load_state_dict(make_weights(seed, model_cfg, device), strict=False)
    if unexpected or any(not k.endswith("rotary.freqs") for k in missing):
        raise RuntimeError(f"weights do not fit the program: missing {missing}, unexpected {unexpected}")
    dcfg = DiffusionConfig(**{k: config["diffusion"][k] for k in DIFFUSION_KEYS})
    return model, GaussianDiffusion(model, dcfg, device=device)


def train_step(diffusion, config: dict, device, mesh=None):
    """(TrainState, train_step) with the configuration's Adan and EMA."""
    from tcdiff_torch.optim.adan import Adan
    from tcdiff_torch.train.state import create_train_state
    from tcdiff_torch.train.train_step import make_train_step

    tc = config["train"]
    model = diffusion.model
    opt = Adan(model.parameters(), lr=tc["learning_rate"], betas=tuple(tc["adan_betas"]), eps=tc["adan_eps"],
               weight_decay=tc["weight_decay"])
    state = create_train_state(model, opt)
    step = make_train_step(diffusion, opt, ema_beta=tc["ema_beta"], ema_interval=tc["ema_interval"], device=device,
                           mesh=mesh)
    return state, step
