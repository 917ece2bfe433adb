"""Trajectory-clamped diffusion sampling with classifier-free guidance,
and the 4-term training loss.

PyTorch counterpart of `tcdiff_tpu/diffusion/gaussian.py`:
- serving: `encode_cond_cfg`, `guided` (one doubled-batch forward,
  unconditional half first, with CFG-prefix dedup) and the samplers, each
  step loop a Python loop:
  - the DDIM family over one loop, `_ddim_loop` (eta from the config,
    clipped x0 prediction, XY trajectory clamped before the loop, after
    every step and at the end): `ddim_sample` (optionally with `forecast_every`,
    AB2 extrapolation of x0 on skipped steps), `long_ddim_sample` (slices of
    one song on the batch axis, half-window coupling, a guidance ramp),
    `long_ddim_sample_sharded` (the same with the slices sharded over
    data-parallel ranks, the coupling a neighbour exchange),
    `ddim_sample_footwork` (leg-chain channels driven by a reference
    motion) and `ddim_sample_stream` (one slice, its first half-window
    inpainted from the previous slice's tail);
  - the DDPM family: `p_sample_loop` (normal, inpaint, long) and
    `partial_denoise`;
- training: `q_sample`, `p_losses` (predict-x0 with p2 weights: the
  reconstruction, velocity, root-relative FK and foot-skate terms; an
  optional `trj_dist` for the TRPE bias, as the JAX package's) and `loss`
  (t drawn uniformly, then `p_losses`).

Data parallelism (`parallel.mesh.Rows`): a rank passes its rows of the
global batch, and every draw (x_T and each step's noise, t, noise,
keep_mask and dropout) is made at the global batch and these rows kept,
so that N ranks compute what one process does.

While a torch.profiler session records, each sampler's loop is the span
`sample.request` (`utils/profiling.span`): the condition's encoding
`sample.cond`, each step `sample.step` (attr `i`), and in it the guided
call `sample.guided` with its CFG combine `sample.cfg`.

Randomness comes from an explicit `torch.Generator`, or is injected so that
the JAX package and this one can be fed the same numbers: the samplers take
`noise={"init": (b, tokens, c), "steps": (S, b, tokens, c)}`, and the draws
the JAX samplers make inside their loop even when noise is given as
`"prev"` (S, b, (seq_len//2)*dn, c) for the stream inpaint and `"value"`
(S, b, tokens, c) for the DDPM inpaint constraint; `partial_denoise` takes
`"q"` (b, tokens, c) for its forward noising. The loss takes `t`, `noise`
and `keep_mask`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tcdiff_torch.config import FOOT_JOINTS, N_JOINTS, DiffusionConfig
from tcdiff_torch.diffusion.schedules import DiffusionBuffers, ddim_times
from tcdiff_torch.geometry.skeleton import smpl_fk_from_6d
from tcdiff_torch.models.dance_decoder import CondCache, DanceDecoder
from tcdiff_torch.parallel.comm import from_previous
from tcdiff_torch.parallel.mesh import Mesh, Rows, draw
from tcdiff_torch.utils.profiling import span, traced


def impose_traj(x: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    """Channels 4,5 (global XY) := the trajectory in x_0's channels 0,1."""
    x = x.clone()
    x[..., 4:6] = x_0[..., 0:2].to(x.dtype)
    return x


def _footwork_channels(joints) -> list:
    """rot6d channel slices (lo, hi) of the leg-chain joints."""
    return [(4 + 3 + (i - 1) * 6, 4 + 3 + i * 6) for i in joints]


def _injected(noise, key: str, dev):
    return None if noise is None or key not in noise else torch.as_tensor(
        noise[key], dtype=torch.float32, device=dev)


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

    def p_losses(self, x_start, cond, t, generator=None, noise=None, keep_mask=None, rows: Optional[Rows] = None,
                 trj_dist=None):
        """The 4-term training loss. x_start (bs, dn, sq, c) as the dataset
        yields it; cond (bs, 301, cond_dim); t (bs,); trj_dist (bs, sq*dn,
        sq*dn) TRPE buckets or None (the model's self-attention then runs
        with the TRPE bias). noise, in the permuted (bs, sq, dn, c) layout,
        and keep_mask (bs,) bool are drawn from `generator` unless given;
        the model's dropout always draws from it. With `rows` (data
        parallelism) x_start, cond, t and trj_dist are this rank's rows of
        the global batch, and noise, keep_mask and the dropout are drawn,
        or injected, at the global batch and these rows kept. Returns
        (total, dict of the four weighted terms), scalars: the means over
        these rows."""
        cfg = self.cfg
        bs, dn, sq, c = x_start.shape
        dev = x_start.device
        x_start = x_start.permute(0, 2, 1, 3)  # (bs, sq, dn, c)
        if noise is None:
            noise = draw(lambda s: torch.randn(s, generator=generator, device=dev), x_start.shape, rows)
        elif rows is not None:
            noise = rows.take(noise)
        x_noisy = self.q_sample(x_start, t, noise)
        # the trajectory channels 4, 5 are never noised
        x_noisy = torch.cat([x_noisy[..., :4], x_start[..., 4:6], x_noisy[..., 6:]], dim=-1)
        if keep_mask is None:
            keep_mask = draw(lambda s: torch.rand(s, generator=generator, device=dev), (bs,), rows) < (
                1.0 - cfg.cond_drop_prob)
        elif rows is not None:
            keep_mask = rows.take(keep_mask)
        out = self.model.forward_train(x_noisy.reshape(bs, sq * dn, c), cond, t, keep_mask, generator, rows,
                                       trj_dist=trj_dist)

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

    def loss(self, x, cond, generator=None, t=None, noise=None, keep_mask=None, rows: Optional[Rows] = None,
             trj_dist=None):
        """t ~ U[0, T) from `generator` unless given, then `p_losses`; with
        `rows`, t too is drawn, or injected, at the global batch (trj_dist,
        like x, holds this rank's rows)."""
        if t is None:
            t = draw(lambda s: torch.randint(0, self.cfg.n_timestep, s, generator=generator, device=x.device),
                     (x.shape[0],), rows)
        elif rows is not None:
            t = rows.take(t)
        return self.p_losses(x, cond, t, generator, noise, keep_mask, rows, trj_dist)

    def encode_cond_cfg(self, cond: torch.Tensor) -> CondCache:
        """Encode the condition once for the doubled (uncond | cond) batch."""
        b = cond.shape[0]
        with span("sample.cond"):
            keep = torch.arange(2 * b, device=cond.device) >= b
            return self.model.cond_cache(torch.cat([cond, cond], dim=0), keep)

    def guided(self, x, cond, t_vec, weight, trj_dist=None, cond_cache=None):
        """unc + (cond - unc) * weight from one doubled-batch forward; x and
        trj_dist at half batch (the x-only prefix runs once)."""
        b = x.shape[0]
        with span("sample.guided"):
            keep = torch.arange(2 * b, device=x.device) >= b
            cc = None if cond_cache is not None else torch.cat([cond, cond], dim=0)
            out = self.model(
                x, cc, torch.cat([t_vec, t_vec], dim=0), keep, trj_dist,
                cond_cache=cond_cache, cfg_pair=True,
            )
            with span("sample.cfg"):
                unc, con = out[:b], out[b:]
                return unc + (con - unc) * weight

    # ------------------------------------------------------------ sampling
    def _start(self, shape, dev, generator, noise, rows: Optional[Rows] = None):
        """x_T: noise["init"] when injected, else drawn; with `rows`, shape
        is the global batch's and this rank's rows of it are returned."""
        if noise is None:
            return draw(lambda s: torch.randn(s, generator=generator, device=dev), shape, rows)
        init = torch.as_tensor(noise["init"], dtype=torch.float32, device=dev)
        return init if rows is None else rows.take(init)

    def _splice_footwork(self, x, x_0, hard: bool):
        """Frames [lo, hi) of the leg-chain rot6d channels from the
        reference motion x_0 (hard), or the final soft blend, with the JAX
        package's quirks: the middle hard copy spans lo+w .. seq_len-w (not
        hi-w), and the blend-out then reads the just-copied values."""
        cfg = self.cfg
        b, seq = x.shape[0], self.model.cfg.seq_len
        lo_f, hi_f = cfg.footwork_frames
        x4 = x.reshape(b, seq, -1, x.shape[-1]).clone()
        ref4 = x_0.reshape(b, seq, -1, x_0.shape[-1]).to(x.dtype)
        w = cfg.footwork_blend_width
        ramp = torch.linspace(0.0, 1.0, w, device=x.device)[None, :, None, None]
        for lo, hi in _footwork_channels(cfg.footwork_joints):
            if hard:
                x4[:, lo_f:hi_f, :, lo:hi] = ref4[:, lo_f:hi_f, :, lo:hi]
                continue
            win = slice(lo_f, lo_f + w)
            x4[:, win, :, lo:hi] = ramp * ref4[:, win, :, lo:hi] + (1 - ramp) * x4[:, win, :, lo:hi]
            x4[:, lo_f + w:seq - w, :, lo:hi] = ref4[:, lo_f + w:seq - w, :, lo:hi]
            win = slice(hi_f - w, hi_f)
            x4[:, win, :, lo:hi] = (1 - ramp) * ref4[:, win, :, lo:hi] + ramp * x4[:, win, :, lo:hi]
        return x4.reshape(x.shape)

    @staticmethod
    def _half_copy(x, rows: int, half: int, mesh: Optional[Mesh] = None):
        """Slice coupling: the first `half` of each slice (batch element)'s
        `rows` := the second half of the slice before it; slice 0 keeps
        its own. With a mesh the slices are sharded in order over the
        ranks: a rank's first slice takes the previous rank's last slice's
        second half (`comm.from_previous`; every rank calls it)."""
        x4 = x.reshape(x.shape[0], rows, -1, x.shape[-1])
        prev = None if mesh is None else from_previous(x4[-1, half:], mesh)
        first = x4[:1, :half] if prev is None else prev[None]
        shifted = torch.cat([first, x4[:-1, half:]], dim=0)
        return torch.cat([shifted, x4[:, half:]], dim=1).reshape(x.shape)

    @torch.no_grad()
    @traced("sample.request")
    def _ddim_loop(self, x, cond, weights: np.ndarray, *, generator=None, noise=None, x_0=None,
                   trj_dist=None, footwork: bool = False, long_mode: bool = False, stream_prev=None,
                   forecast_every: int = 0, rows: Optional[Rows] = None, mesh: Optional[Mesh] = None):
        """The DDIM step loop of every DDIM sampler (the JAX package's
        `_ddim_scan`): x (b, tokens, c) at x_T; weights (S,) the guidance
        weight of each step. Options: the footwork splice, long-form
        half-window coupling, the stream inpaint of the first half-window
        from `stream_prev`, and `forecast_every` >= 2: on skipped steps the
        x0 prediction is extrapolated (AB2) from the previous two instead
        of running the model; the first two and the last step always run
        it. With `rows` x, cond, x_0 and trj_dist are a data-parallel
        rank's rows: each step's noise is drawn, or injected, at the global
        batch and these rows kept; `mesh` couples long-form slices across
        the ranks."""
        cfg, buf = self.cfg, self.buffers
        dev = x.device
        b = x.shape[0]
        seq_len = self.model.cfg.seq_len
        half = seq_len // 2
        steps = _injected(noise, "steps", dev)
        if steps is not None and rows is not None:
            steps = steps[:, rows.start:rows.stop]
        prev_noise = _injected(noise, "prev", dev)
        times = ddim_times(cfg.n_timestep, cfg.sampling_timesteps)
        use_model = np.ones(len(times) - 1, dtype=bool)
        if forecast_every >= 2:
            use_model[:] = False
            use_model[::forecast_every] = True
            use_model[:2] = True
            use_model[-1] = True
        if x_0 is not None:
            x_0 = x_0.to(dev)
            x = impose_traj(x, x_0)
            if footwork:
                x = self._splice_footwork(x, x_0, hard=True)
        if stream_prev is not None:
            prev4 = torch.as_tensor(stream_prev, dtype=torch.float32, device=dev).reshape(b, half, -1, x.shape[-1])

        cond_cache = self.encode_cond_cfg(cond)
        ac = buf.alphas_cumprod
        one = np.float32(1.0)
        s1 = s2 = None  # the last two x0 predictions
        for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
            with span("sample.step", i=i):
                if use_model[i]:
                    t_vec = torch.full((b,), int(time), dtype=torch.int32, device=dev)
                    x_start = self.guided(x, cond, t_vec, float(weights[i]), trj_dist, cond_cache)
                else:
                    x_start = 2.0 * s1 - s2
                if cfg.clip_denoised:
                    x_start = x_start.clamp(-1.0, 1.0)
                s1, s2 = x_start, s1
                pred_noise = (float(buf.sqrt_recip_alphas_cumprod[time]) * x - x_start) / float(
                    buf.sqrt_recipm1_alphas_cumprod[time]
                )
                alpha, alpha_next = ac[time], ac[max(int(time_next), 0)]
                sigma = np.float32(cfg.ddim_eta) * np.sqrt(
                    max((one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), np.float32(0))
                )
                coef = np.sqrt(max(one - alpha_next - sigma * sigma, np.float32(0)))
                eps = (draw(lambda s: torch.randn(s, generator=generator, device=dev), x.shape, rows) if steps is None
                       else steps[i])
                if time_next < 0:
                    x = x_start
                else:
                    x = x_start * float(np.sqrt(alpha_next)) + float(coef) * pred_noise + float(sigma) * eps
                if x_0 is not None:
                    x = impose_traj(x, x_0)
                    if footwork and time_next >= 0:  # the last step's splice is the soft blend below
                        x = self._splice_footwork(x, x_0, hard=True)
                if long_mode and time > 0 and time_next >= 0:
                    x = self._half_copy(x, seq_len, half, mesh)
                if stream_prev is not None:
                    # RePaint-style: the first half-window is the previous
                    # slice's tail, re-noised to the next step's level
                    pn = (torch.randn(prev4.shape, generator=generator, device=dev) if prev_noise is None
                          else prev_noise[i].reshape(prev4.shape))
                    tn = max(int(time_next), 0)
                    prev_t = prev4
                    if time_next > 0:
                        prev_t = float(np.sqrt(ac[tn])) * prev4 + float(np.sqrt(one - ac[tn])) * pn
                    x4 = x.reshape(b, seq_len, -1, x.shape[-1])
                    x = torch.cat([prev_t, x4[:, half:]], dim=1).reshape(x.shape)

        if x_0 is not None:
            x = impose_traj(x, x_0)
            if footwork:
                x = self._splice_footwork(x, x_0, hard=False)
        return x

    def _ddim_weights(self) -> np.ndarray:
        return np.full(self.cfg.sampling_timesteps, self.cfg.guidance_weight, np.float32)

    @torch.no_grad()
    def ddim_sample(self, shape, cond, generator=None, x_0=None, noise=None, trj_dist=None,
                    forecast_every: int = 0, rows: Optional[Rows] = None):
        """DDIM over `cfg.sampling_timesteps` steps. shape: (b, tokens, c);
        cond: (b, 301, cond_dim); x_0: optional (b, tokens, >=2) trajectory
        (XY in channels 0,1); forecast_every >= 2: the opt-in x0 forecast
        (see `_ddim_loop`), 0 the exact sampler. With `rows` (a
        data-parallel rank's share) shape is the global batch's, cond,
        x_0 and trj_dist are this rank's rows, every draw is made at the
        global batch (noise, where injected, is global too) and this rank's
        rows are returned. Runs on cond's device; returns float32."""
        x = self._start(shape, cond.device, generator, noise, rows)
        return self._ddim_loop(x, cond, self._ddim_weights(), generator=generator, noise=noise, x_0=x_0,
                               trj_dist=trj_dist, forecast_every=forecast_every, rows=rows)

    @torch.no_grad()
    def long_ddim_sample(self, shape, cond, generator=None, x_0=None, noise=None):
        """Long-form DDIM: the batch holds consecutive slices of one song;
        after every step but the last, each slice's first half-window
        becomes the previous slice's second half. Guidance ramps from 0 to
        the config's weight over the first half of the steps. One slice is
        plain `ddim_sample`, without the trajectory (as the JAX package).
        `long_ddim_sample_sharded` over a one-process mesh."""
        return self.long_ddim_sample_sharded(shape, cond, Mesh(0, 1, cond.device), generator, x_0, noise)

    @torch.no_grad()
    def long_ddim_sample_sharded(self, shape, cond, mesh: Mesh, generator=None, x_0=None, noise=None):
        """`long_ddim_sample` with the slices sharded in order over the
        mesh's ranks (the JAX package's `long_ddim_sample_sharded`): each
        rank denoises n_slices/N consecutive slices, and the half-window
        coupling crosses rank boundaries by a neighbour exchange on every
        step but the last. shape, cond, x_0 and noise are the global ones
        (noise["init"] sliced on axis 0, noise["steps"] on axis 1; noise
        drawn from `generator` is drawn at the global shape), so the
        result does not depend on N. Every rank calls it; returns this
        rank's slices (`comm.all_gather_rows` gives the whole song). The
        one-slice rule is decided on the global count, so that a rank
        holding one slice of several keeps x_0."""
        rows = mesh.rows(shape[0])
        if shape[0] == 1:
            return self.ddim_sample(shape, cond, generator, x_0=None, noise=noise)
        s, gw = self.cfg.sampling_timesteps, self.cfg.guidance_weight
        weights = np.clip(np.linspace(0, gw * 2, s), None, gw).astype(np.float32)
        x = self._start(shape, cond.device, generator, noise, rows)
        return self._ddim_loop(x, rows.take(cond), weights, generator=generator, noise=noise,
                               x_0=None if x_0 is None else rows.take(x_0), long_mode=True, rows=rows, mesh=mesh)

    @torch.no_grad()
    def ddim_sample_footwork(self, shape, cond, generator=None, x_0=None, noise=None):
        """Footwork-adaptor DDIM: the leg-chain rot6d channels of frames
        `cfg.footwork_frames` follow the reference motion x_0
        (b, tokens, nfeats; XY trajectory in its channels 0,1), spliced
        after every step and blended in and out at the end."""
        if x_0 is None:
            raise ValueError("ddim_sample_footwork needs the reference motion x_0")
        x = self._start(shape, cond.device, generator, noise)
        return self._ddim_loop(x, cond, self._ddim_weights(), generator=generator, noise=noise, x_0=x_0,
                               footwork=True)

    @torch.no_grad()
    def ddim_sample_stream(self, shape, cond, generator=None, x_0=None, prev_tail=None, noise=None):
        """Causal single-slice DDIM for streaming: the slice's first
        half-window is inpainted from `prev_tail`, the previous slice's
        generated second half ((b, (seq_len//2)*dn, nfeats); None for the
        first slice), re-noised to each step's level."""
        x = self._start(shape, cond.device, generator, noise)
        return self._ddim_loop(x, cond, self._ddim_weights(), generator=generator, noise=noise, x_0=x_0,
                               stream_prev=prev_tail)

    def _ddpm_weights(self, n: int) -> np.ndarray:
        """Per-timestep guidance, clipped to at most 1 below 0.1 T."""
        w = np.full(n, self.cfg.guidance_weight, np.float32)
        w[np.arange(n) < 0.1 * self.cfg.n_timestep] = min(self.cfg.guidance_weight, 1.0)
        return w

    @torch.no_grad()
    @traced("sample.request")
    def p_sample_loop(self, shape, cond, generator=None, noise=None, start_point=None, mode: str = "normal",
                      constraint=None, x_init=None):
        """Ancestral DDPM from `start_point` (default T) down to 0; mode
        "normal", "inpaint" (constraint={"mask", "value"}, each (b, tokens,
        c): value noised to each step's level replaces x where mask is 1)
        or "long" (the batch holds slices of one song; after every step but
        the last each slice's first half of the tokens becomes the previous
        slice's second half). x_init replaces the drawn x_T."""
        cfg, buf = self.cfg, self.buffers
        if mode not in ("normal", "inpaint", "long"):
            raise ValueError(f"unknown mode {mode!r}")
        dev = cond.device
        b = shape[0]
        start = cfg.n_timestep if start_point is None else int(start_point)
        half = shape[1] // 2
        if x_init is not None:
            x = torch.as_tensor(x_init, dtype=torch.float32, device=dev)
        else:
            x = self._start(shape, dev, generator, noise)
        steps, values = _injected(noise, "steps", dev), _injected(noise, "value", dev)
        if mode == "inpaint":
            mask = torch.as_tensor(constraint["mask"], dtype=torch.float32, device=dev)
            value = torch.as_tensor(constraint["value"], dtype=torch.float32, device=dev)
        w_tab = self._ddpm_weights(cfg.n_timestep)
        pm1, pm2, plv = buf.posterior_mean_coef1, buf.posterior_mean_coef2, buf.posterior_log_variance_clipped

        cond_cache = self.encode_cond_cfg(cond)
        for i in range(start):
            with span("sample.step", i=i):
                t = start - 1 - i
                t_vec = torch.full((b,), t, dtype=torch.int32, device=dev)
                x_recon = self.guided(x, cond, t_vec, float(w_tab[t]), cond_cache=cond_cache)
                if cfg.clip_denoised:
                    x_recon = x_recon.clamp(-1.0, 1.0)
                mean = float(pm1[t]) * x_recon + float(pm2[t]) * x
                z = torch.randn(x.shape, generator=generator, device=dev) if steps is None else steps[i]
                x = mean + float(np.exp(np.float32(0.5) * plv[t])) * z if t != 0 else mean
                if mode == "inpaint":
                    vnoise = torch.randn(value.shape, generator=generator, device=dev) if values is None else values[i]
                    if t > 0:
                        value_t = self.q_sample(value, (t_vec - 1).clamp(min=0).long(), vnoise)
                        x = value_t * mask + (1.0 - mask) * x
                elif mode == "long" and t > 0:
                    x = self._half_copy(x, shape[1], half)
        return x

    @torch.no_grad()
    def partial_denoise(self, x, cond, t: int, generator=None, noise=None):
        """Noise x (b, tokens, c) to level t, then run the DDPM loop from t
        back to 0 (refinement of a given motion)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=cond.device)
        x_noisy = x
        if t > 0:
            q = _injected(noise, "q", x.device)
            if q is None:
                q = torch.randn(x.shape, generator=generator, device=x.device)
            x_noisy = self.q_sample(x, torch.full((x.shape[0],), t, dtype=torch.long, device=x.device), q)
        return self.p_sample_loop(tuple(x.shape), cond, generator, noise, start_point=t, x_init=x_noisy)
