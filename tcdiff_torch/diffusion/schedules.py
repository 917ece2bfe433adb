"""Beta schedules and the DDIM step table.

Copy of the numpy math in `tcdiff_tpu/diffusion/schedules.py` (that module
cannot be imported without JAX: its package imports the JAX sampler).
Everything is computed in float64 numpy and stored float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionBuffers:
    """The per-timestep coefficient tables the samplers and the loss read
    (float32, (T,))."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_log_variance_clipped: np.ndarray  # the DDPM step's
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    p2_loss_weight: np.ndarray

    @classmethod
    def create(cls, schedule: str = "cosine", n_timestep: int = 1000, use_p2: bool = False) -> "DiffusionBuffers":
        # float32 betas first, then float32 products (as the JAX tables)
        betas = make_beta_schedule(schedule, n_timestep).astype(np.float32)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.concatenate([np.ones(1, np.float32), alphas_cumprod[:-1]])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        p2_gamma = 0.5 if use_p2 else 0.0
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            p2_loss_weight=f32((1.0 + alphas_cumprod / (1 - alphas_cumprod)) ** -p2_gamma),
        )


def ddim_times(n_timestep: int, sampling_timesteps: int) -> np.ndarray:
    """Descending [(time, time_next)] endpoints: linspace(-1, T-1, S+1)
    truncated to int then reversed."""
    times = np.linspace(-1, n_timestep - 1, sampling_timesteps + 1)
    return np.trunc(times).astype(np.int32)[::-1]
