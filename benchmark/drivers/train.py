"""Traffic kind `train`: back-to-back calls of the port's train step
(`train.train_step.make_train_step`: loss, backward, the flat gradient
all-reduce over NCCL where dp > 1, Adan, EMA) on normalised motion and
music held on the device, drawn from the seed.

Traffic file keys: batch (rows a rank), dp (ranks, one a card; rank 0 is
this process and prints the line, ranks 1.. are spawned), pool (global
batches drawn in set-up; step i takes batch i mod pool), motion_scale (the
motion's std), estimate_steps (steps timed in set-up to size the window),
trace_steps (steps under the profiler with --trace 1), check_block_rows
(rows a block of the float32 reference).

Set-up builds the one train state, drives it through its first three
steps (batches 0, 1, 2: rows that all differ) through the window's own
call, keeping the loss of each, the first gradient's norms (as Adan holds
it after step 1) and the change of the parameters and the EMA over the
three; then times `estimate_steps` more, and the window runs
ceil(seconds / their mean) steps on every rank. End-to-end:
train_samples_per_s = window steps x global batch / the window's wall
time, which ends in a synchronize.
"""

from __future__ import annotations

import datetime
import math
import queue
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist

from benchmark import compare, faults, harness, program
from benchmark import device as devmod
from benchmark.reference import diffusion as refdiff
from benchmark.reference.model import ReferenceDecoder
from benchmark.weights import generator, make_weights, sub_seed

CHECKED_STEPS = 3
JOIN_TIMEOUT_S = 180  # the ranks' join and every collective


def global_batch(run: harness.Run, k: int, dev):
    """Global batch k: motion (G, dancers, frames, nfeats), music (G, 301,
    438)."""
    mc, tr = run.model_cfg, run.traffic
    g = generator(run.seed, dev, "batch", k)
    rows = tr["batch"] * tr["dp"]
    x = tr["motion_scale"] * torch.randn((rows, mc["dancer_num"], mc["seq_len"], mc["nfeats"]), generator=g,
                                         device=dev)
    cond = torch.randn((rows, 2 * mc["seq_len"] + 1, mc["cond_feature_dim"]), generator=g, device=dev)
    return x, cond


def _norms(ts) -> list:
    return torch.stack(torch._foreach_norm(list(ts))).tolist()


def _moment(opt, p, key: str):
    """Adan's state entry of p (zeros where the optimizer holds none)."""
    t = opt.state[p].get(key) if p in opt.state else None
    return torch.zeros_like(p) if t is None else t


def _digest(tensors, dev) -> int:
    """A position-weighted sum of every bit pattern (int64, wrapping): equal
    states give equal digests, a changed bit almost surely another."""
    h = torch.zeros((), dtype=torch.int64, device=dev)
    for i, t in enumerate(tensors):
        v = t.detach().contiguous().view(torch.int32).flatten().to(torch.int64)
        h += (v * (torch.arange(v.numel(), device=dev, dtype=torch.int64) % 65521 + 1 + i)).sum()
    return int(h.item())


def _rank(run: harness.Run, rank: int, world: int, port: int) -> dict:
    dev = torch.device(f"cuda:{rank}") if run.device == "cuda" else torch.device(run.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    mesh = None
    if world > 1:
        from tcdiff_torch.parallel.mesh import make_mesh

        dist.init_process_group(run.backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
        mesh = make_mesh(world, 1, device=dev)
        if on_card and mesh.backend != "nccl":
            raise RuntimeError(f"the ranks joined over {mesh.backend}; across cards the cell runs NCCL")
    try:
        with faults.planted(run.faults):
            res = _work(run, rank, dev, mesh)
        if on_card:
            torch.cuda.empty_cache()
        harness.log(run, f"rank {rank}: reference start")
        res["reference"] = reference(run, dev, rank=rank, ranks=world)
        harness.log(run, f"rank {rank}: reference done")
        res["forbidden"] = devmod.forbidden_modules()
        return res
    finally:
        if world > 1:
            dist.destroy_process_group()


def _work(run: harness.Run, rank: int, dev, mesh) -> dict:
    tr, cell = run.traffic, run.cell
    on_card = dev.type == "cuda"
    model, diffusion = program.build(run.model_cfg, run.config, run.seed, dev)
    state, step = program.train_step(diffusion, run.config, dev, mesh)
    b = tr["batch"]
    pool = []
    for k in range(tr["pool"]):
        x, cond = global_batch(run, k, dev)
        pool.append((x[rank * b:(rank + 1) * b].clone(), cond[rank * b:(rank + 1) * b].clone()))
        del x, cond
    gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, "steps"))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = state.optimizer
    done = 0

    def one():
        nonlocal done, state
        state, m = step(state, *pool[done % len(pool)], gen)
        done += 1
        return m

    harness.log(run, f"rank {rank}: train state and {len(pool)} batches built")
    p0 = [p.detach().clone() for p in params]
    losses, terms, grad_norms = [], [], None
    for k in range(CHECKED_STEPS):
        m = one()
        losses.append(m["total"].detach())
        terms.append({t: m[t].detach() for t in refdiff.TERMS})
        if k == 0:
            grad_norms = _norms(_moment(opt, p, "prev_grad") for p in params)
    change = _norms(p.detach() - q for p, q in zip(params, p0))
    ema_change = _norms(state.ema_params[n] - q for n, q in zip(names, p0))
    del p0
    harness.sync(dev)
    harness.log(run, f"rank {rank}: {CHECKED_STEPS} checked steps done")
    t = time.perf_counter()
    for _ in range(tr["estimate_steps"]):
        one()
    harness.sync(dev)
    steps = torch.tensor([max(1, math.ceil(run.seconds / ((time.perf_counter() - t) / tr["estimate_steps"])))],
                         device=dev)
    if mesh is not None:
        dist.broadcast(steps, 0)  # every rank runs rank 0's count; also the window's start line
    steps = int(steps.item())
    harness.sync(dev)
    setup_s = run.elapsed()
    harness.log(run, f"rank {rank}: set-up done, {steps} window steps")
    t0 = time.perf_counter()
    for _ in range(steps):
        m = one()
    harness.sync(dev)
    wall = time.perf_counter() - t0
    harness.log(run, f"rank {rank}: window {steps} steps in {wall:.3f} s")
    res = {"setup_s": setup_s, "wall": wall, "steps": steps, "nonfinite": int(not math.isfinite(m["total"].item())),
           "loss": [float(v) for v in losses], "terms": [{t: float(v) for t, v in d.items()} for d in terms],
           "grad_norms": dict(zip(names, grad_norms)), "change": dict(zip(names, change)),
           "ema_change": dict(zip(names, ema_change))}
    if run.trace:
        k, kind = tr["trace_steps"], torch.cuda.get_device_name(dev) if on_card else "cpu"

        def reading():
            trace = devmod.capture(lambda: [one() for _ in range(k)], k)
            return harness.Reading(cell, run.model_cfg, tr, trace, steps, wall,
                                   torch.cuda.max_memory_allocated(dev) if on_card else 0, devmod.peaks(kind))

        per_layer, r = harness.traced(cell, reading, agree=lambda again: _any_rank(again, mesh, dev))
        res.update(per_layer=per_layer, busy_s=r.trace.busy_s, window_s=r.trace.window_s,
                   breakdown={"device_ops": r.trace.top_ops(), "idle_gaps": r.trace.idle_gaps()})
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else 0
    moments = [_moment(opt, p, k) for p in params for k in ("m", "v", "n", "prev_grad")]
    res["digest"] = _digest(params + [state.ema_params[n] for n in names] + moments, dev)
    return res


def _child(run: harness.Run, rank: int, world: int, port: int, q) -> None:
    try:
        q.put((rank, _rank(run, rank, world, port)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(run: harness.Run) -> list:
    """Every rank's result, rank 0's computed here, the others' in spawned
    processes (each waited for)."""
    world = run.traffic["dp"]
    if world == 1:
        return [_rank(run, 0, 1, 0)]
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q, port = ctx.Queue(), _free_port()
    procs = [ctx.Process(target=_child, args=(run, r, world, port, q)) for r in range(1, world)]
    for p in procs:
        p.start()
    results = {}
    try:
        results[0] = _rank(run, 0, world, port)
        while len(results) < world:
            try:
                r, res = q.get(timeout=30)
            except queue.Empty:
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank processes {dead} ended without a result")
                continue
            if "error" in res:
                raise RuntimeError(f"rank {r} failed:\n{res['error']}")
            results[r] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(world)]


def _any_rank(flag: bool, mesh, dev) -> bool:
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _sum_over_ranks(tensors) -> None:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def reference(run: harness.Run, dev, mm=None, rank: int = 0, ranks: int = 1) -> dict:
    """The float32 reference's readings of the three checked steps on the
    global batches (TF32 off). With `ranks` > 1 (the ranks of a joined
    group) each computes the rows [rank G/ranks, (rank+1) G/ranks) and the
    gradients and losses are summed over the ranks: every rank returns the
    whole step's readings."""
    mc, conf, tr = run.model_cfg, run.cell.config, run.traffic
    total = tr["batch"] * tr["dp"]
    rows = total // ranks
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.device(dev):
            ref = ReferenceDecoder(mc, **({} if mm is None else {"mm": mm}))
        w0 = make_weights(run.seed, mc, dev)
        ref.load_state_dict(w0, strict=False)
        batches = []
        for k in range(CHECKED_STEPS):
            x, cond = global_batch(run, k, dev)
            batches.append((x[rank * rows:(rank + 1) * rows].clone(), cond[rank * rows:(rank + 1) * rows].clone()))
            del x, cond
        got = refdiff.train_steps(ref, mc, conf["diffusion"], conf["train"], batches, sub_seed(run.seed, "steps"),
                                  tr["check_block_rows"], total, rank * rows, _sum_over_ranks if ranks > 1 else None)
        del batches
        params = dict(ref.named_parameters())
        return {"loss": got["loss"], "terms": got["terms"], "grad_norms": got["grad_norms"],
                "change": {k: (p.detach() - w0[k]).norm().item() for k, p in params.items()},
                "ema_change": {k: (got["ema"][k] - w0[k]).norm().item() for k in params}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run(run: harness.Run) -> harness.Outcome:
    tr, cell = run.traffic, run.cell
    ranks = _ranks(run)
    r0 = ranks[0]
    numbers = compare.train_numbers(r0, r0["reference"])
    checks = {k: (numbers[k], lim) for k, lim in cell.limits.items() if k in numbers}
    checks["window_nonfinite"] = (sum(r["nonfinite"] for r in ranks), 0)
    if len(ranks) > 1:
        checks["ranks_differ"] = (sum(r["digest"] != r0["digest"] for r in ranks[1:]), 0)
    readings = {k: v for k, v in numbers.items() if isinstance(v, float) and k not in checks}
    print(f"train check: change_gap's worst leaf {numbers['_change_gap_worst_leaf']:.4g} "
          f"({numbers['_change_gap_worst_name']}), over {numbers['_moving_leaves']} moving leaves; the three steps' "
          f"loss gaps {numbers['_loss_steps']}; not compared {readings}", file=sys.stderr)
    out = harness.Outcome(
        setup_s=r0["setup_s"],
        end_to_end={"train_samples_per_s": r0["steps"] * tr["batch"] * tr["dp"] / r0["wall"]},
        attempted=r0["steps"], failed=0, checks=checks,
        memory_peak_bytes=max(r["memory_peak_bytes"] for r in ranks), count=len(ranks), readings=readings,
        forbidden=sorted({m for r in ranks for m in r["forbidden"]}))
    if run.trace:
        names = set.intersection(*(set(r["per_layer"]) for r in ranks))
        out.per_layer = {k: sum(r["per_layer"][k] for r in ranks) / len(ranks) for k in sorted(names)}
        out.busy_s = sum(r["busy_s"] for r in ranks) / len(ranks)
        out.window_s = sum(r["window_s"] for r in ranks) / len(ranks)
        out.breakdown = r0["breakdown"]
    return out
