"""The plain reference of TCDiff's sampler and training step, in float32.

- `Schedule`: the cosine beta schedule (Nichol & Dhariwal), alphas and
  their cumulative product in float64, stored float32.
- `ddim_sample`: 50-step DDIM (eta from the configuration) with
  classifier-free guidance (unconditional and conditional halves of one
  doubled batch, unc + (cond - unc) * w, `guided_x0`), the x0 prediction
  clipped to [-1, 1], and the given XY trajectory written into channels
  4, 5 of x before the loop, after every step and at the end; its two
  stages, the guided prediction and the step (`ddim_update`), also alone.
  The noise is passed in (x_T and each step's), so that the caller decides
  where it comes from.
- `p_losses`: the 4-term loss of a predict-x0 model: reconstruction,
  velocity, root-relative forward kinematics of the SMPL skeleton, and the
  foot-skate term where the predicted contact exceeds 0.95.
- `train_steps`: loss, backward, Adan and the EMA, for a few steps, over
  the batch in blocks of rows so that the float32 activations fit.

Imports nothing of the measured package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.model import ReferenceDecoder

TERMS = ("recon", "velocity", "fk", "foot")  # the loss's weighted terms
FOOT_JOINTS = (7, 8, 10, 11)  # the 4 contact channels' joints: ankles, toes
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
SMPL_OFFSETS = (
    (0.0, 0.0, 0.0), (0.05858135, -0.08228004, -0.01766408), (-0.06030973, -0.09051332, -0.01354254),
    (0.00443945, 0.12440352, -0.03838522), (0.04345142, -0.38646945, 0.008037),
    (-0.04325663, -0.38368791, -0.00484304), (0.00448844, 0.1379564, 0.02682033),
    (-0.01479032, -0.42687458, -0.037428), (0.01905555, -0.4200455, -0.03456167),
    (-0.00226458, 0.05603239, 0.00285505), (0.04105436, -0.06028581, 0.12204243),
    (-0.03483987, -0.06210566, 0.13032329), (-0.0133902, 0.21163553, -0.03346758),
    (0.07170245, 0.11399969, -0.01889817), (-0.08295366, 0.11247234, -0.02370739),
    (0.01011321, 0.08893734, 0.05040987), (0.12292141, 0.04520509, -0.019046),
    (-0.11322832, 0.04685326, -0.00847207), (0.2553319, -0.01564902, -0.02294649),
    (-0.26012748, -0.01436928, -0.03126873), (0.26570925, 0.01269811, -0.00737473),
    (-0.26910836, 0.00679372, -0.00602676), (0.08669055, -0.01063603, -0.01559429),
    (-0.0887537, -0.00865157, -0.01010708),
)


class Schedule:
    def __init__(self, n_timestep: int, s: float = 8e-3):
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + s
        f = np.cos(steps / (1 + s) * np.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.n = n_timestep

    def ddim_pairs(self, steps: int):
        times = np.trunc(np.linspace(-1, self.n - 1, steps + 1)).astype(np.int64)[::-1]
        return list(zip(times[:-1].tolist(), times[1:].tolist()))


def with_traj(x: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :4], x_0[..., 0:2], x[..., 6:]], dim=-1)


@torch.no_grad()
def guided_x0(model: ReferenceDecoder, dcfg: dict, x, cond, t: int) -> torch.Tensor:
    """The guided x0 prediction (not clipped) of x (b, tokens, nfeats) at
    timestep t: one forward of the doubled (unconditional | conditional)
    batch, unc + (cond - unc) * w."""
    b = x.shape[0]
    keep = torch.arange(2 * b, device=x.device) >= b
    times = torch.full((2 * b,), t, device=x.device, dtype=torch.int64)
    out = model(torch.cat([x, x]), torch.cat([cond, cond]), times, keep)
    return out[:b] + (out[b:] - out[:b]) * dcfg["guidance_weight"]


def ddim_update(sched: Schedule, dcfg: dict, x, x0, t: int, t_next: int, eps) -> torch.Tensor:
    """One DDIM step from x at t to t_next given the clipped x0 prediction
    and the step's noise (the last step, t_next < 0, returns x0)."""
    if t_next < 0:
        return x0
    ac = sched.alphas_cumprod.astype(np.float64)
    a, a_next = ac[t], ac[t_next]
    pred_noise = (x / math.sqrt(a) - x0) / math.sqrt(1.0 / a - 1.0)
    sigma = dcfg["ddim_eta"] * math.sqrt(max((1 - a / a_next) * (1 - a_next) / (1 - a), 0.0))
    c = math.sqrt(max(1 - a_next - sigma * sigma, 0.0))
    return x0 * math.sqrt(a_next) + c * pred_noise + sigma * eps


@torch.no_grad()
def ddim_sample(model: ReferenceDecoder, dcfg: dict, cond, x_0, x_T, step_noise: Callable[[int], torch.Tensor]):
    """x (b, tokens, nfeats) after `dcfg["sampling_timesteps"]` DDIM steps
    from x_T; step_noise(i) is step i's noise."""
    sched = Schedule(dcfg["n_timestep"])
    x = with_traj(x_T, x_0)
    for i, (t, t_next) in enumerate(sched.ddim_pairs(dcfg["sampling_timesteps"])):
        x0 = guided_x0(model, dcfg, x, cond, t).clamp(-1.0, 1.0)
        x = with_traj(ddim_update(sched, dcfg, x, x0, t, t_next, step_noise(i)), x_0)
    return x


# ----------------------------------------------------------------- training
def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt of the two encoded rows; the rows of the matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.stack([b1, b2, _cross(b1, b2)], dim=-2)


def forward_kinematics(rot6d: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """World joint positions (..., 24, 3) of the SMPL chain from local 6D
    rotations (..., 24, 6) and the root position (..., 3): a joint's world
    rotation is its parent's times its local one, its position the
    parent's plus the parent's world rotation applied to its rest offset."""
    rm = rot6d_to_matrix(rot6d)
    offsets = torch.tensor(SMPL_OFFSETS, dtype=root.dtype, device=root.device)
    world_r: List[Optional[torch.Tensor]] = [None] * 24
    pos: List[Optional[torch.Tensor]] = [None] * 24
    world_r[0], pos[0] = rm[..., 0, :, :], root
    for j in range(1, 24):
        p = SMPL_PARENTS[j]
        pos[j] = pos[p] + torch.einsum("...ck,k->...c", world_r[p], offsets[j])
        world_r[j] = torch.matmul(world_r[p], rm[..., j, :, :])
    return torch.stack(pos, dim=-2)


def _mse(a, b):
    return ((a - b) ** 2).mean(dim=tuple(range(1, a.dim())))


def p_losses(model: ReferenceDecoder, dcfg: dict, x_start, cond, t, noise, keep, enc_masks, layer_seeds,
             rate: float, ac: torch.Tensor):
    """(total, the four weighted terms) summed over these rows (each term a
    per-sample mean), so that blocks of rows add up; the caller divides by
    the whole batch. x_start (bs, dn, sq, c); noise (bs, sq, dn, c)."""
    bs, dn, sq, c = x_start.shape
    x0 = x_start.permute(0, 2, 1, 3)
    a = ac[t].reshape(-1, 1, 1, 1)
    x_noisy = a.sqrt() * x0 + (1 - a).sqrt() * noise
    x_noisy = torch.cat([x_noisy[..., :4], x0[..., 4:6], x_noisy[..., 6:]], dim=-1)
    out = model.forward_train(x_noisy.reshape(bs, sq * dn, c), cond, t, keep, enc_masks, layer_seeds, rate)
    out = out.reshape(bs, sq, dn, c)
    recon = _mse(out, x0)
    o, g = out[..., 4:], x0[..., 4:]
    vel = _mse(o[:, 1:] - o[:, :-1], g[:, 1:] - g[:, :-1])
    fk = lambda r: forward_kinematics(r[..., 3:].reshape(bs, sq * dn, 24, 6), r[..., :3].reshape(bs, sq * dn, 3))
    po, pg = fk(o), fk(g)
    fk_l = _mse(po[:, :, 1:] - po[:, :, :1], pg[:, :, 1:] - pg[:, :, :1])
    feet = po.reshape(bs, sq, dn, 24, 3)[:, :, :, list(FOOT_JOINTS)]
    fv = torch.cat([feet[:, 1:] - feet[:, :-1], torch.zeros_like(feet[:, :1])], dim=1)
    fv = torch.where((out[..., :4] > 0.95)[..., None], fv, torch.zeros_like(fv))
    foot = (fv ** 2).mean(dim=tuple(range(1, fv.dim())))
    terms = {"recon": dcfg["w_recon"] * recon.sum(), "velocity": dcfg["w_velocity"] * vel.sum(),
             "fk": dcfg["w_fk"] * fk_l.sum(), "foot": dcfg["w_foot"] * foot.sum()}
    return sum(terms.values()), terms


class Draws:
    """One train step's random numbers, drawn from the step's generator in
    the order the measured step draws them: t, noise, the classifier-free
    keep mask, the cond encoder's dropout masks, then each decoder layer's
    three seed vectors."""

    def __init__(self, gen: torch.Generator, cfg: dict, dcfg: dict, bs: int, device):
        dn, sq, c, d = cfg["dancer_num"], cfg["seq_len"], cfg["nfeats"], cfg["latent_dim"]
        rate, nh, lc = cfg["dropout"], cfg["num_heads"], sq
        self.t = torch.randint(0, dcfg["n_timestep"], (bs,), generator=gen, device=device)
        self.noise = torch.randn((bs, sq, dn, c), generator=gen, device=device)
        self.keep = torch.rand((bs,), generator=gen, device=device) < 1.0 - dcfg["cond_drop_prob"]
        keep = lambda *s: torch.rand(s, generator=gen, device=device) >= rate
        self.enc = []
        for _ in range(2):
            self.enc += [keep(bs, nh, lc, lc), keep(bs, lc, d), keep(bs, lc, cfg["ff_size"]), keep(bs, lc, d)]
        seeds = lambda: torch.randint(0, 2**32, (bs,), generator=gen, device=device, dtype=torch.int64)
        self.layers = [(seeds(), seeds(), seeds()) for _ in range(cfg["num_layers"])]

    def rows(self, lo: int, hi: int):
        return (self.t[lo:hi], self.noise[lo:hi], self.keep[lo:hi], [m[lo:hi] for m in self.enc],
                [tuple(s[lo:hi] for s in seeds) for seeds in self.layers])


class Adan:
    """Adan as upstream uses it: the moments stay zero on the first step,
    bias corrections on the post-increment count, decoupled weight decay
    as a division after the step; a parameter without a gradient steps
    with a zero one."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, eps, wd):
        self.p, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, wd
        self.state = {k: {m: torch.zeros_like(v) for m in ("m", "v", "n", "prev")} for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]):
        b1, b2, b3 = self.betas
        first = self.count == 0
        self.count += 1
        cm, cv, cn = (1.0 / (1.0 - (1.0 - b) ** self.count) for b in (b1, b2, b3))
        for k, p in self.p.items():
            s = self.state[k]
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g
            if not first:
                diff = g - s["prev"]
                s["m"].mul_(1 - b1).add_(g, alpha=b1)
                s["v"].mul_(1 - b2).add_(diff, alpha=b2)
                s["n"].mul_(1 - b3).add_((g + (1 - b2) * diff) ** 2, alpha=b3)
            upd = (s["m"] * cm + (1 - b2) * s["v"] * cv) / ((s["n"] * cn).sqrt() + self.eps)
            p.copy_((p - self.lr * upd) / (1.0 + self.wd * self.lr))
            s["prev"].copy_(g)


def train_steps(model: ReferenceDecoder, cfg: dict, dcfg: dict, tcfg: dict, batches, generator_seed: int,
                block_rows: int, total_rows: Optional[int] = None, row0: int = 0,
                reduce: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """Runs len(batches) train steps of the reference on (x, cond) batches
    with draws from a generator seeded `generator_seed` (the measured step's
    own). With `total_rows` the batches are rows [row0, row0 + rows) of
    global batches of that many (every draw made at the global batch) and
    `reduce` sums a list of tensors over the processes that hold the other
    rows, in place. Returns {"loss": [...], "terms": [{term: its weighted
    mean}, ...] (recon, velocity, fk, foot), "grad_norms": {name: |g| of
    step 1}, "ema": {name: EMA after the last step}}; the model holds the
    parameters after the last step."""
    dev = next(model.parameters()).device
    params = dict(model.named_parameters())
    opt = Adan(params, tcfg["learning_rate"], tuple(tcfg["adan_betas"]), tcfg["adan_eps"], tcfg["weight_decay"])
    ema = {k: v.detach().clone() for k, v in params.items()}
    ac = torch.tensor(Schedule(dcfg["n_timestep"]).alphas_cumprod, device=dev)
    gen = torch.Generator(device=dev).manual_seed(generator_seed)
    out = {"loss": [], "terms": [], "grad_norms": None}
    for step, (x, cond) in enumerate(batches):
        rows = x.shape[0]
        total = rows if total_rows is None else total_rows
        draws = Draws(gen, cfg, dcfg, total, dev)
        model.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=dev)
        term_sum = torch.zeros(len(TERMS), device=dev)
        for lo in range(0, rows, block_rows):
            hi = min(rows, lo + block_rows)
            t, noise, keep, enc, seeds = draws.rows(row0 + lo, row0 + hi)
            loss, terms = p_losses(model, dcfg, x[lo:hi], cond[lo:hi], t, noise, keep, enc, seeds, cfg["dropout"],
                                   ac)
            (loss / total).backward()
            loss_sum += loss.detach() / total
            term_sum += torch.stack([terms[k].detach() for k in TERMS]) / total
        held = [p for p in params.values() if p.grad is not None]
        if reduce is not None:
            reduce([loss_sum, term_sum] + [p.grad for p in held])
        grads = {k: p.grad for k, p in params.items()}
        if step == 0:
            out["grad_norms"] = {k: (0.0 if g is None else g.norm().item()) for k, g in grads.items()}
        opt.step(grads)
        with torch.no_grad():
            for k, p in params.items():
                ema[k].mul_(tcfg["ema_beta"]).add_(p, alpha=1 - tcfg["ema_beta"])
        out["loss"].append(loss_sum.item())
        out["terms"].append(dict(zip(TERMS, term_sum.tolist())))
    out["ema"] = ema
    return out
