"""Trajectory-clamped DDIM sampling with classifier-free guidance, and the
4-term training loss.

PyTorch counterpart of `tcdiff_tpu/diffusion/gaussian.py`:
- serving: `encode_cond_cfg`, `guided` (one doubled-batch forward,
  unconditional half first, with CFG-prefix dedup) and `ddim_sample`
  (DDIM, eta from the config, clipped x0 prediction, XY trajectory clamped
  before the loop, after every step and at the end), the steps as a
  Python loop;
- training: `q_sample`, `p_losses` (predict-x0 with p2 weights: the
  reconstruction, velocity, root-relative FK and foot-skate terms) and
  `loss` (t drawn uniformly, then `p_losses`).

Randomness comes from an explicit `torch.Generator`, or is injected
(`noise={"init": (b, tokens, c), "steps": (S, b, tokens, c)}` for the
sampler; `t`, `noise` and `keep_mask` for the loss) so that the JAX package
and this one can be fed the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from tcdiff_torch.config import FOOT_JOINTS, N_JOINTS, DiffusionConfig
from tcdiff_torch.diffusion.schedules import DiffusionBuffers, ddim_times
from tcdiff_torch.geometry.skeleton import smpl_fk_from_6d
from tcdiff_torch.models.dance_decoder import CondCache, DanceDecoder


def impose_traj(x: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    """Channels 4,5 (global XY) := the trajectory in x_0's channels 0,1."""
    x = x.clone()
    x[..., 4:6] = x_0[..., 0:2].to(x.dtype)
    return x


def _per_sample_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean(dim=tuple(range(1, a.dim())))


class GaussianDiffusion:
    """Sampler and loss bound to a DanceDecoder; holds the f32 coefficient
    tables, those the loss indexes by t also on `device` (the GPU unless
    the caller asks for the CPU; the model must live there too)."""

    def __init__(self, model: DanceDecoder, cfg: DiffusionConfig, device="cuda"):
        self.device = torch.empty(0, device=device).device  # raises where the device does not exist
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"model parameter {name} is on {p.device}, the diffusion on {self.device}")
        self.model = model
        self.cfg = cfg
        self.buffers = DiffusionBuffers.create(cfg.schedule, cfg.n_timestep, cfg.use_p2)
        tab = lambda a: torch.from_numpy(a).to(self.device)
        self._sqrt_ac = tab(self.buffers.sqrt_alphas_cumprod)
        self._sqrt_1m_ac = tab(self.buffers.sqrt_one_minus_alphas_cumprod)
        self._p2 = tab(self.buffers.p2_loss_weight)

    # ------------------------------------------------------------- training
    def q_sample(self, x_start, t, noise):
        """Forward process q(x_t | x_0); t (b,) broadcasts over the trailing
        dims of x_start."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        return self._sqrt_ac[t].reshape(shape) * x_start + self._sqrt_1m_ac[t].reshape(shape) * noise

    def p_losses(self, x_start, cond, t, generator=None, noise=None, keep_mask=None):
        """The 4-term training loss. x_start (bs, dn, sq, c) as the dataset
        yields it; cond (bs, 301, cond_dim); t (bs,). noise, in the permuted
        (bs, sq, dn, c) layout, and keep_mask (bs,) bool are drawn from
        `generator` unless given; the model's dropout always draws from it.
        Returns (total, dict of the four weighted terms), scalars."""
        cfg = self.cfg
        bs, dn, sq, c = x_start.shape
        dev = x_start.device
        x_start = x_start.permute(0, 2, 1, 3)  # (bs, sq, dn, c)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        x_noisy = self.q_sample(x_start, t, noise)
        # the trajectory channels 4, 5 are never noised
        x_noisy = torch.cat([x_noisy[..., :4], x_start[..., 4:6], x_noisy[..., 6:]], dim=-1)
        if keep_mask is None:
            keep_mask = torch.rand(bs, generator=generator, device=dev) < 1.0 - cfg.cond_drop_prob
        out = self.model.forward_train(x_noisy.reshape(bs, sq * dn, c), cond, t, keep_mask, generator)

        target = x_start  # predict-x0
        out = out.reshape(bs, sq, dn, c)
        p2 = self._p2[t]
        recon = _per_sample_mse(out, target) * p2
        out_rest, target_rest = out[..., 4:], target[..., 4:]
        v_loss = _per_sample_mse(out_rest[:, 1:] - out_rest[:, :-1],
                                 target_rest[:, 1:] - target_rest[:, :-1]) * p2

        # FK on normalised values, root-relative joints
        fk = lambda rest: smpl_fk_from_6d(rest[..., 3:].reshape(bs, sq * dn, N_JOINTS, 6),
                                          rest[..., :3].reshape(bs, sq * dn, 3))
        out_xp, target_xp = fk(out_rest), fk(target_rest)
        fk_loss = _per_sample_mse(out_xp[:, :, 1:] - out_xp[:, :, :1],
                                  target_xp[:, :, 1:] - target_xp[:, :, :1]) * p2

        # foot skate: foot velocity where the predicted contact is > 0.95
        feet = out_xp.reshape(bs, sq, dn, N_JOINTS, 3)[:, :, :, list(FOOT_JOINTS), :]
        static = out[..., :4] > 0.95
        foot_v = torch.cat([feet[:, 1:] - feet[:, :-1], torch.zeros_like(feet[:, :1])], dim=1)
        foot_v = torch.where(static[..., None], foot_v, torch.zeros_like(foot_v))
        foot_loss = (foot_v**2).mean(dim=tuple(range(1, foot_v.dim())))

        losses = {
            "recon": cfg.w_recon * recon.mean(),
            "velocity": cfg.w_velocity * v_loss.mean(),
            "fk": cfg.w_fk * fk_loss.mean(),
            "foot": cfg.w_foot * foot_loss.mean(),
        }
        return sum(losses.values()), losses

    def loss(self, x, cond, generator=None, t=None, noise=None, keep_mask=None):
        """t ~ U[0, T) from `generator` unless given, then `p_losses`."""
        if t is None:
            t = torch.randint(0, self.cfg.n_timestep, (x.shape[0],), generator=generator, device=x.device)
        return self.p_losses(x, cond, t, generator, noise, keep_mask)

    def encode_cond_cfg(self, cond: torch.Tensor) -> CondCache:
        """Encode the condition once for the doubled (uncond | cond) batch."""
        b = cond.shape[0]
        keep = torch.arange(2 * b, device=cond.device) >= b
        return self.model.cond_cache(torch.cat([cond, cond], dim=0), keep)

    def guided(self, x, cond, t_vec, weight, trj_dist=None, cond_cache=None):
        """unc + (cond - unc) * weight from one doubled-batch forward; x and
        trj_dist at half batch (the x-only prefix runs once)."""
        b = x.shape[0]
        keep = torch.arange(2 * b, device=x.device) >= b
        cc = None if cond_cache is not None else torch.cat([cond, cond], dim=0)
        out = self.model(
            x, cc, torch.cat([t_vec, t_vec], dim=0), keep, trj_dist,
            cond_cache=cond_cache, cfg_pair=True,
        )
        unc, con = out[:b], out[b:]
        return unc + (con - unc) * weight

    @torch.no_grad()
    def ddim_sample(self, shape, cond, generator=None, x_0=None, noise=None, trj_dist=None):
        """DDIM over `cfg.sampling_timesteps` steps. shape: (b, tokens, c);
        cond: (b, 301, cond_dim); x_0: optional (b, tokens, >=2) trajectory
        (XY in channels 0,1). Runs on cond's device; returns float32."""
        cfg, buf = self.cfg, self.buffers
        dev = cond.device
        if noise is None:
            draw = lambda: torch.randn(shape, generator=generator, device=dev)
            x = draw()
        else:
            steps = torch.as_tensor(noise["steps"], dtype=torch.float32, device=dev)
            x = torch.as_tensor(noise["init"], dtype=torch.float32, device=dev)
        if x_0 is not None:
            x_0 = x_0.to(dev)
            x = impose_traj(x, x_0)

        cond_cache = self.encode_cond_cfg(cond)
        times = ddim_times(cfg.n_timestep, cfg.sampling_timesteps)
        ac = buf.alphas_cumprod
        one = np.float32(1.0)
        for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
            t_vec = torch.full((shape[0],), int(time), dtype=torch.int32, device=dev)
            x_start = self.guided(x, cond, t_vec, cfg.guidance_weight, trj_dist, cond_cache)
            if cfg.clip_denoised:
                x_start = x_start.clamp(-1.0, 1.0)
            pred_noise = (float(buf.sqrt_recip_alphas_cumprod[time]) * x - x_start) / float(
                buf.sqrt_recipm1_alphas_cumprod[time]
            )
            alpha, alpha_next = ac[time], ac[max(int(time_next), 0)]
            sigma = np.float32(cfg.ddim_eta) * np.sqrt(
                max((one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), np.float32(0))
            )
            coef = np.sqrt(max(one - alpha_next - sigma * sigma, np.float32(0)))
            eps = draw() if noise is None else steps[i]
            if time_next < 0:
                x = x_start
            else:
                x = x_start * float(np.sqrt(alpha_next)) + float(coef) * pred_noise + float(sigma) * eps
            if x_0 is not None:
                x = impose_traj(x, x_0)
        return x
