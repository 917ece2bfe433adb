"""Traffic kind `sample`: one client in a closed loop, each request one
`GaussianDiffusion.ddim_sample` call of `batch` clips (the configuration's
DDIM steps, eta and guidance; the XY trajectory x_0 given and clamped),
the next sent once the last has come back (synchronised).

Traffic file keys: batch, pool (distinct (cond, x_0) inputs drawn from the
seed in set-up; request i takes input i mod pool), traj_scale (x_0's
std), clip_seconds (motion seconds a clip), warmup_requests,
trace_requests (requests under the profiler with --trace 1), check_rows
(clips of each request whose path is kept, drawn from the seed),
check_clips (of those, how many the reference follows), kernels (the
serving configuration, `ServingKernels` fields; {} the default).

Each request draws its noise from a generator seeded by (seed, request
index), so the reference can draw the same. End-to-end: motion_s_per_s =
clips completed in the window x clip_seconds / the window's wall time.

The comparison follows the served path step by step. With 50 stochastic
steps of a network of random weights, any rounding grows along the path
(bf16 and the int8 path both end 4-6% from the float32 reference's free
run, PERF.md), so the reference is run on the program's own states: the
sampler's guided call is wrapped to keep, for the kept clips, each step's
state x_t and the guided x0 prediction it returned (two row copies a step).
Judged: the start (x_T with the trajectory) against the reference's from
the same noise; every step's x0 against the reference's guided prediction
from the same state; every next state, and the served clip, against the
reference's DDIM step from the program's own state, x0 and noise.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import compare, faults, harness, program
from benchmark import device as devmod
from benchmark.reference import diffusion as refdiff
from benchmark.reference.model import ReferenceDecoder
from benchmark.weights import generator, make_weights, sub_seed


def _inputs(run: harness.Run):
    mc, tr = run.model_cfg, run.traffic
    g = generator(run.seed, run.device, "inputs")
    b, tokens = tr["batch"], mc["seq_len"] * mc["dancer_num"]
    return [(torch.randn((b, 2 * mc["seq_len"] + 1, mc["cond_feature_dim"]), generator=g, device=run.device),
             tr["traj_scale"] * torch.randn((b, tokens, 3), generator=g, device=run.device))
            for _ in range(tr["pool"])]


def _shape(run: harness.Run):
    mc = run.model_cfg
    return run.traffic["batch"], mc["seq_len"] * mc["dancer_num"], mc["nfeats"]


def kept_rows(run: harness.Run, i: int):
    rng = random.Random(sub_seed(run.seed, "rows", i))
    return sorted(rng.sample(range(run.traffic["batch"]), min(run.traffic["check_rows"], run.traffic["batch"])))


class Recorder:
    """Wraps a GaussianDiffusion's guided call: for the request running,
    keeps the kept rows of each step's input state and guided output."""

    def __init__(self, diffusion):
        self.inner, self.paths, self.path, self.idx = diffusion.guided, {}, None, None
        diffusion.guided = self.guided

    def start(self, i: int, rows, device) -> dict:
        self.idx = torch.tensor(rows, device=device)
        self.path = self.paths[i] = {"rows": rows, "x": [], "x0": []}
        return self.path

    def guided(self, x, cond, t_vec, weight, trj_dist=None, cond_cache=None):
        out = self.inner(x, cond, t_vec, weight, trj_dist, cond_cache)
        self.path["x"].append(x.index_select(0, self.idx))
        self.path["x0"].append(out.index_select(0, self.idx))
        return out


def check_path(run: harness.Run, paths, pool, round_update=None, control_mm=None) -> dict:
    """The reference along the kept clips' recorded paths (float32, TF32
    off): start_abs_err, x0_rel_err (the widest over clips and steps; and
    x0_median, their median, printed), update_rel_err (the widest over
    clips and steps, the last against the served clip). The controls (`benchmark/tools/control.py`):
    `round_update` (a dtype) rounds the reference's step; `control_mm` puts
    the reference with that product in the program's place for x0."""
    mc, dev, dcfg = run.model_cfg, run.device, run.cell.config["diffusion"]
    shape = _shape(run)
    steps = dcfg["sampling_timesteps"]
    x_t, eps, cond, x_0 = [], [[] for _ in range(steps)], [], []
    for i, path in paths:
        rows = path["rows"]
        g = generator(run.seed, dev, "request", i)
        x_t.append(torch.randn(shape, generator=g, device=dev)[rows])
        for s in range(steps):
            eps[s].append(torch.randn(shape, generator=g, device=dev)[rows])
        cond.append(pool[i % len(pool)][0][rows])
        x_0.append(pool[i % len(pool)][1][rows])
    cond, x_0, x_t, eps = torch.cat(cond), torch.cat(x_0), torch.cat(x_t), [torch.cat(e) for e in eps]
    xs = [torch.cat([p["x"][s] for _, p in paths]) for s in range(steps)]
    x0s = [torch.cat([p["x0"][s] for _, p in paths]) for s in range(steps)]
    final = torch.cat([p["final"] for _, p in paths])
    rel = lambda got, want: max(compare.clip_errors(got, want))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.device(dev):
            ref = ReferenceDecoder(mc)
        ref.load_state_dict(make_weights(run.seed, mc, dev), strict=False)
        if control_mm is not None:
            with torch.device(dev):
                ctl = ReferenceDecoder(mc, mm=control_mm)
            ctl.load_state_dict(ref.state_dict())
        sched = refdiff.Schedule(dcfg["n_timestep"])
        out = {"start_abs_err": (xs[0] - refdiff.with_traj(x_t, x_0)).abs().max().item(), "x0_rel_err": 0.0,
               "update_rel_err": 0.0}
        table = []
        for s, (t, t_next) in enumerate(sched.ddim_pairs(steps)):
            if control_mm is not None:
                x0s[s] = refdiff.guided_x0(ctl, dcfg, xs[s], cond, t)
            errs = compare.clip_errors(x0s[s], refdiff.guided_x0(ref, dcfg, xs[s], cond, t))
            table += errs
            out["x0_rel_err"] = max(out["x0_rel_err"], max(errs))
            step = refdiff.ddim_update(sched, dcfg, xs[s], x0s[s].clamp(-1.0, 1.0), t, t_next, eps[s])
            if round_update is not None:
                step = step.to(round_update).float()
            want = refdiff.with_traj(step, x_0)
            out["update_rel_err"] = max(out["update_rel_err"], rel(xs[s + 1] if s + 1 < steps else final, want))
        out["x0_median"] = torch.tensor(table).median().item()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run(run: harness.Run) -> harness.Outcome:
    with faults.planted(run.faults):
        return _run(run)


def _run(run: harness.Run, round_update=None, control_mm=None) -> harness.Outcome:
    tr, dev, cell = run.traffic, run.device, run.cell
    from tcdiff_torch.config import ServingKernels

    model, diffusion = program.build(run.model_cfg, run.config, run.seed, dev, ServingKernels(**tr["kernels"]))
    pool = _inputs(run)
    rec = Recorder(diffusion)
    shape = _shape(run)

    def request(i: int):
        cond, x_0 = pool[i % len(pool)]
        path = rec.start(i, kept_rows(run, i), dev)
        out = diffusion.ddim_sample(shape, cond, generator=generator(run.seed, dev, "request", i), x_0=x_0)
        path["final"] = out.index_select(0, rec.idx)
        return out, x_0

    for i in range(tr["warmup_requests"]):
        request(-1 - i)
    harness.sync(dev)
    rec.paths.clear()
    setup_s = run.elapsed()
    harness.log(run, "set-up done")

    n, off, t0 = 0, 0, time.perf_counter()
    while True:
        out, x_0 = request(n)
        harness.sync(dev)
        off += compare.clips_off(out, x_0)
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    del out
    harness.log(run, f"window: {n} requests in {wall:.3f} s")
    result = harness.Outcome(setup_s=setup_s,
                             end_to_end={"motion_s_per_s": n * tr["batch"] * tr["clip_seconds"] / wall},
                             attempted=n, failed=0, checks={}, memory_peak_bytes=0, count=1)
    on_card = torch.device(dev).type == "cuda"
    if run.trace:
        k, kind = tr["trace_requests"], torch.cuda.get_device_name(dev) if on_card else "cpu"
        traced = [n]

        def reading():
            trace = devmod.capture(lambda: [request(traced[0] + j) for j in range(k)], k)
            traced[0] += k
            return harness.Reading(cell, run.model_cfg, tr, trace, n, wall,
                                   torch.cuda.max_memory_allocated(dev) if on_card else 0, devmod.peaks(kind))

        result.per_layer, r = harness.traced(cell, reading)
        result.busy_s, result.window_s = r.trace.busy_s, r.trace.window_s
        result.breakdown = {"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()}
    result.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0

    rng = random.Random(sub_seed(run.seed, "check"))
    chosen = sorted(rng.sample(range(n), min(n, max(1, tr["check_clips"] // tr["check_rows"]))))
    paths = [(i, rec.paths[i]) for i in chosen]
    del rec, diffusion, model
    if on_card:
        torch.cuda.empty_cache()
    harness.log(run, "reference start")
    got = check_path(run, paths, pool, round_update, control_mm)
    harness.log(run, f"reference done: {sum(len(p['rows']) for _, p in paths)} clips x "
                     f"{cell.config['diffusion']['sampling_timesteps']} steps; x0's median gap {got['x0_median']:.5f}")
    result.checks = {k: (got[k], cell.limits[k]) for k in ("x0_rel_err", "update_rel_err")}
    result.checks.update(start_abs_err=(got["start_abs_err"], 0.0), clips_off=(off, 0))
    return result
