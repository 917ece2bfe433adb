"""Drive the PyTorch port (tcdiff_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printed as it runs; any failure exits non-zero before the
last line:
  1. the card's name and power limit (nvidia-smi); no card -> exit 2;
  2. build the CUDA kernels from tcdiff_torch/csrc, one nvcc per source,
     all at once;
  3. hold each serving kernel (K1, K2) against its plain PyTorch version
     at the serving shapes (b=8 doubled CFG batch, L=450, d=512), in bf16
     and f32, and time both;
  4. hold each train kernel (K3, K4, K5) against its plain version at the
     main path's train shapes (b=64, L=450, Lm=152, d=512), in bf16 and
     f32, dropout 0.1 with the same seeds: the output and every gradient
     under one cotangent; time the forward and forward+backward of both;
  5. serve 3 requests (batch 4 each: 3 dancers x 5 s of motion) through
     GaussianDiffusion.ddim_sample on a full-width bf16 DanceDecoder with
     seeded random weights, check the outputs and the kernels' launch
     counts, then run one request in f32 through the kernels and through
     the plain versions on the same noise and compare;
  6. train: 1 warm-up and 3 timed steps (loss, backward, Adan, EMA) of the
     full-width bf16 DanceDecoder at batch 64, dropout 0.1, on seeded
     synthetic motion and music; check a finite loss, finite parameters
     and the train kernels' launch counts (8 layers x 4 steps, forward and
     backward); then two f32 steps at batch 4 through the kernels and two
     through the plain versions on the same weights and draws: each step's
     loss and gradients, and the parameters after the second Adan step;
  7. a line of JSON with every kernel's figures, the card's line, and the
     last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from tcdiff_torch import DanceDecoderConfig, DiffusionConfig, TrainConfig
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.models.dance_decoder import DanceDecoder
from tcdiff_torch.models.rotary import angle_table
from tcdiff_torch.ops import _build, ca_block_train, ff_block, ff_block_train, sa_block, sa_block_train
from tcdiff_torch.ops.plain import plain_blocks
from tcdiff_torch.optim.adan import Adan
from tcdiff_torch.train.state import create_train_state
from tcdiff_torch.train.train_step import make_train_step

B, L, D, H, FF = 8, 450, 512, 8, 1024  # serving shapes: CFG-doubled batch of 4
HD = H * 64
LM = 152  # cross-attention memory: 150 music rows + 2 time tokens
REQUESTS, REQ_BATCH, CLIP_S = 3, 4, 5.0
F32_PATH_TOL = 1e-3  # f32 whole 50-step path, kernels vs plain (sums in another order)
TRAIN_BATCH, TRAIN_STEPS = 64, 3  # bench.py's train default; + 1 warm-up step
F32_STEP_BATCH = 4
RATE = 0.1  # the config's dropout
KERNELS = ("sa_block", "ff_tail", "sa_block_train", "ca_block_train", "ff_tail_train")
REPLACES = {
    "sa_block": "tcdiff_tpu/ops/fused_sa_block.py:75",
    "ff_tail": "tcdiff_tpu/ops/fused_ff_block.py:88",
    "sa_block_train": "tcdiff_tpu/ops/fused_sa_block_train.py:474",
    "ca_block_train": "tcdiff_tpu/ops/fused_ca_block_train.py:244",
    "ff_tail_train": "tcdiff_tpu/ops/fused_ff_block_train.py:261",
}
# H100 SXM data-sheet peaks at 700 W: dense bf16 tensor cores, HBM3
PEAK_BF16, HBM_RATE = 989e12, 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def tolerance(dtype, ref: torch.Tensor) -> float:
    """f32: 1e-4 of the output scale (the sums run in another order).
    bf16: 4 bf16 ulps of the largest output (2^-5 of it): q/k/v, the
    attention weights and the outputs are each rounded to bf16, and a
    rounding that lands on the other side moves an output by an ulp."""
    scale = max(1.0, ref.abs().max().item())
    return (2.0**-5 if dtype == torch.bfloat16 else 1e-4) * scale


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def grad_tolerance(dtype, ref: torch.Tensor) -> float:
    """A gradient: f32 1e-4 of its largest value (sums in another order);
    bf16 2^-4 of it, since the plain version's autograd rounds dP, dO and
    the weight-gradient operands to bf16 at other points than the kernels."""
    scale = max(ref.abs().max().item(), 1e-6)
    return (2.0**-4 if dtype == torch.bfloat16 else 1e-4) * scale


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the bf16 tensor
    core time of the work and the HBM time of reading each input and
    writing each output once."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def compare_kernels(gen: torch.Generator) -> dict:
    """Phase 3. Returns the main-path (bf16) figures of each kernel."""
    dev = "cuda"
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    angles = angle_table(L, D, dev)
    dist = torch.randint(0, 10, (B, L, L), generator=gen, device=dev, dtype=torch.int32)
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rnd(B, L, D).to(dtype)
        w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
        s1, b1 = ln()
        s2, b2 = ln()
        wq, wk, wv, wfc = w(H * 64, D), w(H * 64, D), w(H * 64, D), w(D, H * 64)
        table = rnd(10, H * 64).to(dtype)
        fs, fb = rnd(B, D, std=0.1).to(dtype), rnd(B, D, std=0.1).to(dtype)
        for film in (False, True):
            for trpe in (False, True):
                args = (x, s1, b1, angles, wq, wk, wv, wfc, s2, b2,
                        table if trpe else None, dist if trpe else None,
                        fs if film else None, fb if film else None)
                out = sa_block.sa_block(*args, nhead=H)
                ref = sa_block.sa_block_plain(*args, nhead=H)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = tolerance(dtype, ref)
                ms = time_ms(lambda: sa_block.sa_block(*args, nhead=H))
                plain_ms = time_ms(lambda: sa_block.sa_block_plain(*args, nhead=H))
                print(f"K1 sa_block {name} film={film} trpe={trpe}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
                check(torch.isfinite(out).all().item(), "K1 output not finite")
                check(err <= tol, f"K1 {name} film={film} trpe={trpe} disagrees: {err} > {tol}")
                if dtype == torch.bfloat16 and film and not trpe:  # the serving variant
                    flops = 8 * B * L * D * HD + 4 * B * L * L * HD
                    figures["sa_block"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               **bound(flops, nbytes(*args, out)), library_ms=None)

        s3, b3 = ln()
        s4, b4 = ln()
        w1, w2, w3 = w(FF, D), w(D, FF), w(D, D)
        bb1, bb2, bb3 = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1)
        args = (x, s3, b3, w1, bb1, w2, bb2, fs, fb, s4, b4, w3, bb3)
        out = ff_block.ff_tail(*args)
        ref = ff_block.ff_tail_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype, ref)
        ms = time_ms(lambda: ff_block.ff_tail(*args))
        plain_ms = time_ms(lambda: ff_block.ff_tail_plain(*args))
        print(f"K2 ff_tail {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        check(torch.isfinite(out).all().item(), "K2 output not finite")
        check(err <= tol, f"K2 {name} disagrees: {err} > {tol}")
        if dtype == torch.bfloat16:
            flops = 4 * B * L * D * FF + 2 * B * L * D * D
            figures["ff_tail"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      **bound(flops, nbytes(*args, out)), library_ms=None)
    return figures


def train_cases(gen: torch.Generator, dtype):
    """{name: (kernel, plain, args, indices of the differentiable args,
    keywords, fwd+bwd FLOPs)} at the main path's train shapes: b=64,
    L=450, Lm=152, d=512, so also its grids and split-row partials."""
    dev, b = "cuda", TRAIN_BATCH
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    film = lambda: (rnd(b, D, std=0.1).to(dtype), rnd(b, D, std=0.1).to(dtype))
    seeds = lambda: torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
    M, Mm = b * L, b * LM
    sab = (rnd(b, L, D).to(dtype), *ln(), angle_table(L, D, dev), w(HD, D), w(HD, D), w(HD, D),
           w(D, HD), *ln(), *film(), seeds())
    cab = (rnd(b, L, D).to(dtype), rnd(b, LM, D).to(dtype), *ln(), angle_table(L, D, dev),
           angle_table(LM, D, dev), w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), *film(), seeds())
    ffb = (rnd(b, L, D).to(dtype), *ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1),
           *film(), *ln(), w(D, D), rnd(D, std=0.1), seeds())
    attn = dict(nhead=H, rate=RATE)
    return {
        # forward: 8 M d hd of projections, 4 b L Lk hd of attention; the
        # backward twice both (input and weight gradients; dV, dP, dQ, dK)
        "sa_block_train": (sa_block_train.sa_block_train, sa_block_train.sa_block_train_plain, sab,
                           (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11), attn,
                           24 * M * D * HD + 12 * b * L * L * HD),
        "ca_block_train": (ca_block_train.ca_block_train, ca_block_train.ca_block_train_plain, cab,
                           (0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13), attn,
                           12 * M * D * HD + 12 * Mm * D * HD + 12 * b * L * LM * HD),
        "ff_tail_train": (ff_block_train.ff_tail_train, ff_block_train.ff_tail_train_plain, ffb,
                          tuple(range(13)), dict(rate=RATE), 3 * (4 * M * D * FF + 2 * M * D * D)),
    }


def compare_train_kernels(gen: torch.Generator) -> dict:
    """Phase 4. Returns the bf16 figures of each train kernel."""
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, (fn, plain, args, diff, kw, flops) in train_cases(gen, dtype).items():
            leaves = lambda: [a.detach().clone().requires_grad_(i in diff) if a.is_floating_point() else a
                              for i, a in enumerate(args)]
            lk, lp = leaves(), leaves()
            out = fn(*lk, **kw)
            ref = plain(*lp, **kw)
            cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            grads = torch.autograd.grad(out, [lk[i] for i in diff], cot)
            grads_p = torch.autograd.grad(ref, [lp[i] for i in diff], cot)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(dtype, ref.float())
            check(torch.isfinite(out).all().item(), f"{name} output not finite")
            check(err <= tol, f"{name} {dname} output disagrees: {err} > {tol}")
            worst = 0.0  # the largest gradient error as a share of its tolerance
            for i, g, gp in zip(diff, grads, grads_p):
                gerr = (g.float() - gp.float()).abs().max().item()
                gtol = grad_tolerance(dtype, gp.float())
                check(torch.isfinite(g).all().item(), f"{name} gradient {i} not finite")
                check(gerr <= gtol, f"{name} {dname} gradient of input {i} disagrees: {gerr} > {gtol}")
                worst = max(worst, gerr / gtol)
            diff_leaves = lambda ls: [ls[i] for i in diff]
            fwd_ms = time_ms(lambda: fn(*lk, **kw))
            plain_fwd_ms = time_ms(lambda: plain(*lp, **kw))
            ms = time_ms(lambda: torch.autograd.grad(fn(*lk, **kw), diff_leaves(lk), cot))
            plain_ms = time_ms(lambda: torch.autograd.grad(plain(*lp, **kw), diff_leaves(lp), cot))
            print(f"{name} {dname} rate {RATE}: output max_abs_err {err:.3e} (tol {tol:.3e}), every "
                  f"gradient within tolerance (largest error {worst:.3f} of its tolerance); "
                  f"fwd kernel {fwd_ms:.3f} ms plain {plain_fwd_ms:.3f} ms; "
                  f"fwd+bwd kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
            if dtype == torch.bfloat16:
                io = nbytes(*args, out, cot, *grads)  # inputs + cotangent read, output + gradients written
                figures[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(flops, io),
                                     library_ms=None, fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                                     grad_err_share_of_tol=worst)
    return figures


def check_output(out: torch.Tensor, x_0: torch.Tensor, shape) -> None:
    check(tuple(out.shape) == tuple(shape), f"output shape {tuple(out.shape)} != {shape}")
    check(torch.isfinite(out).all().item(), "output not finite")
    check(torch.equal(out[..., 4:6], x_0[..., :2]), "XY channels differ from the trajectory")
    rest = torch.cat([out[..., :4], out[..., 6:]], dim=-1)
    check(rest.abs().max().item() <= 1.0, "a channel left [-1, 1]")


def serve(gen: torch.Generator) -> dict:
    """Phase 5: the serving path through ddim_sample."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)
    reqs = [
        (torch.randn((REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda"),
         0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda"))
        for _ in range(REQUESTS)
    ]
    diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1])  # warm-up
    torch.cuda.synchronize()

    sa_block.sa_block.launches = 0
    ff_block.ff_tail.launches = 0
    t0 = time.perf_counter()
    outs = [diff.ddim_sample(shape, cond, generator=gen, x_0=x_0) for cond, x_0 in reqs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sa_block": sa_block.sa_block.launches, "ff_tail": ff_block.ff_tail.launches}

    for out, (_, x_0) in zip(outs, reqs):
        check_output(out, x_0, shape)
    want = cfg.num_layers * dcfg.sampling_timesteps * REQUESTS
    print(f"main path: {REQUESTS} requests of batch {REQ_BATCH}, bf16: launches {launches} "
          f"(expected {want} each)")
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times, expected {want}")
    per_req = seconds / REQUESTS
    motion = REQUESTS * REQ_BATCH * CLIP_S
    print(f"main path: {per_req:.3f} s per request, {motion / seconds:.2f} s-motion/s (bf16, kernels)")

    with plain_blocks(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    print(f"plain blocks: {plain_s:.3f} s per request, {REQ_BATCH * CLIP_S / plain_s:.2f} s-motion/s (bf16)")

    # f32, same injected noise: kernels against plain versions, whole path
    model.dtype = torch.float32
    cond, x_0 = reqs[0]
    noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
             "steps": torch.randn((dcfg.sampling_timesteps,) + shape, generator=gen, device="cuda")}
    out_k = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
    with plain_blocks(model):
        out_p = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
    check_output(out_k, x_0, shape)
    err = (out_k - out_p).abs().max().item()
    print(f"f32 path, kernels vs plain on the same noise: max_abs_diff {err:.3e} (tol {F32_PATH_TOL:.0e})")
    check(err <= F32_PATH_TOL, f"f32 path disagrees: {err} > {F32_PATH_TOL}")
    return launches


def train_launches() -> dict:
    return {name: (getattr(mod, name).launches, getattr(mod, name).bwd_launches)
            for mod, name in ((sa_block_train, "sa_block_train"), (ca_block_train, "ca_block_train"),
                              (ff_block_train, "ff_tail_train"))}


def reset_train_launches() -> None:
    for mod, name in ((sa_block_train, "sa_block_train"), (ca_block_train, "ca_block_train"),
                      (ff_block_train, "ff_tail_train")):
        getattr(mod, name).launches = getattr(mod, name).bwd_launches = 0


def make_trainer(cfg, dtype):
    """A full-width model with seeded random weights and its train step,
    with TrainConfig's Adan and EMA settings."""
    tcfg = TrainConfig()
    model = DanceDecoder(cfg, dtype=dtype).init_random(torch.Generator().manual_seed(0))
    opt = Adan(model.parameters(), lr=tcfg.learning_rate, betas=tcfg.adan_betas, eps=tcfg.adan_eps,
               weight_decay=tcfg.weight_decay)
    step = make_train_step(GaussianDiffusion(model, DiffusionConfig()), opt, ema_beta=tcfg.ema_beta,
                           ema_interval=tcfg.ema_interval)
    return model, create_train_state(model, opt), step


def train_inputs(cfg, batch: int, seed: int):
    """bench.py's synthetic train batch: motion N(0, 0.3^2), music N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 0.3 * torch.randn((batch, cfg.dancer_num, cfg.seq_len, cfg.nfeats), generator=g, device="cuda")
    cond = torch.randn((batch, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=g, device="cuda")
    return x, cond


def train(card: str) -> dict:
    """Phase 6: the train path. Returns the train kernels' launch counts."""
    cfg = DanceDecoderConfig(dancer_num=3)
    model, state, step = make_trainer(cfg, torch.bfloat16)
    x, cond = train_inputs(cfg, TRAIN_BATCH, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    state, m = step(state, x, cond, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, x, cond, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = train_launches()
    want = cfg.num_layers * (TRAIN_STEPS + 1)
    metrics = {k: round(v.item(), 6) for k, v in m.items()}
    print(f"train on {card}: batch {TRAIN_BATCH} bf16, {TRAIN_STEPS} timed steps after 1 warm-up: "
          f"{TRAIN_STEPS / seconds:.3f} steps/s, {TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} samples/s, "
          f"{1e3 * seconds / TRAIN_STEPS:.1f} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last metrics {metrics}")
    print(f"train: launches (forward, backward) {launches} (expected {want} each)")
    check(all(torch.isfinite(v).item() for v in m.values()), f"train metrics not finite: {metrics}")
    check(all(torch.isfinite(p).all().item() for p in model.parameters()), "parameters not finite")
    for name, (fwd, bwd) in launches.items():
        check(fwd == want and bwd == want, f"{name} launched ({fwd}, {bwd}) times, expected {want}")
    del model, state, step
    torch.cuda.empty_cache()

    # f32, two steps through the kernels and two through the plain versions:
    # same weights, inputs and generator seed, so the same t, noise, keep
    # mask and dropout seeds (and so the same hash masks). Adan's first step
    # only shrinks the weights; the second moves them by the moments, so
    # the parameters after it depend on both steps' gradients.
    model_k, state_k, step_k = make_trainer(cfg, torch.float32)
    model_p, state_p, step_p = make_trainer(cfg, torch.float32)
    start = {name: p.detach().clone() for name, p in model_p.named_parameters()}
    x, cond = train_inputs(cfg, F32_STEP_BATCH, 3)
    gen_k, gen_p = (torch.Generator(device="cuda").manual_seed(4) for _ in range(2))
    named_p = dict(model_p.named_parameters())
    for i in (1, 2):
        _, m_k = step_k(state_k, x, cond, gen_k)
        with plain_blocks(model_p):
            _, m_p = step_p(state_p, x, cond, gen_p)
        torch.cuda.synchronize()
        # loss: 1e-4 relative; each gradient: 1e-3 of its largest value (8
        # layers of f32 sums in another order, forward and back)
        loss_err = abs(m_k["total"].item() - m_p["total"].item()) / abs(m_p["total"].item())
        worst_grad, worst_name = 0.0, ""
        for name, pk in model_k.named_parameters():
            pp = named_p[name]
            if pp.grad is None:
                check(pk.grad is None, f"{name} has a gradient through the kernels only")
                continue
            share = (pk.grad - pp.grad).abs().max().item() / (1e-3 * max(pp.grad.abs().max().item(), 1e-12))
            if share > worst_grad:
                worst_grad, worst_name = share, name
        print(f"train f32 batch {F32_STEP_BATCH}, kernels vs plain, step {i}: loss {m_k['total'].item():.6f} "
              f"vs {m_p['total'].item():.6f} (rel diff {loss_err:.2e}, tol 1e-4); largest gradient "
              f"difference {worst_grad:.3f} of its tolerance ({worst_name})")
        check(loss_err <= 1e-4, f"f32 train loss of step {i} disagrees: {loss_err}")
        check(worst_grad <= 1.0, f"f32 train gradient of {worst_name} in step {i} disagrees "
                                 f"({worst_grad} of tolerance)")
    # Parameters after the second Adan step. Adan divides each moment by the
    # root of its second moment, so it moves an element by about lr whatever
    # the size of its gradient: where a gradient is small against its
    # tensor's largest, or its two steps' terms nearly cancel, the rounding
    # differences of f32 sums taken in another order become differences of
    # the order of lr. A wrong gradient moves most elements of its tensor
    # so, rounding few. Check: in each tensor at most 5% of the elements
    # differ by more than lr/10. This is the coarse check at the end of the
    # step; the gradients' own (1e-3 of the largest) is the fine one.
    lr = TrainConfig().learning_rate
    worst, worst_name, n_off, n_all, max_diff = 0.0, "", 0, 0, 0.0
    for name, pk in model_k.named_parameters():
        diff = (pk.detach() - named_p[name].detach()).abs()
        off = int((diff > 0.1 * lr).sum().item())
        n_off, n_all, max_diff = n_off + off, n_all + diff.numel(), max(max_diff, diff.max().item())
        if off / diff.numel() > worst:
            worst, worst_name = off / diff.numel(), name
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in model_p.named_parameters())
    print(f"train f32: parameters after two Adan steps: {n_off} of {n_all} elements differ by more than "
          f"lr/10; largest share in a tensor {worst:.3e} (tol 5e-2; {worst_name}); largest difference "
          f"{max_diff / lr:.3e} x lr; largest move from the start {moved / lr:.3e} x lr")
    check(worst <= 5e-2, f"f32 parameters after two Adan steps disagree: {worst_name} {worst}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        t0 = time.perf_counter()
        _build.build_all(KERNELS)
        for name in KERNELS:
            _build.load(name)
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

        gen = torch.Generator(device="cuda").manual_seed(0)
        figures = compare_kernels(gen)
        figures.update(compare_train_kernels(gen))
        launches = serve(gen)
        t0 = time.perf_counter()
        train_counts = train(card)
        print(f"train phase took {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    launches.update({name: fwd for name, (fwd, _) in train_counts.items()})
    bwd = {name: {"bwd_launches": b} for name, (_, b) in train_counts.items()}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"tcdiff_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name], **figures[name], **bwd.get(name, {})}
        for name in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
