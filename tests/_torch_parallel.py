"""The ranks of a (dp, tp) mesh for the port's multi-process tests.

`run_ranks` spawns dp x tp processes (`torch.multiprocessing.spawn`; by
default WORLD data-parallel ranks), which join one gloo group through a
`file://` store under the test's temporary directory (no TCP port, so that
pytest-xdist workers cannot clash), build the (dp, tp) mesh, run one case
function of this module on it, save what it returns and leave the group;
the calling test compares. Each file starts its ranks once, in a module
fixture that runs all its cases. This module imports no JAX: the JAX
references run in the pytest process.

The case functions take (mesh, payload) and return a dict a rank saves:
`train_cases` (the dp train step against JAX's, against the port's dp = 1
at dropout 0.1, the DBN's step, and the CLI's rank-0 files),
`sample_cases` (the sharded long sampler and normal-mode `_sample`),
`tp_cases` (the tp train step against JAX's and against one process at
dropout 0.1, with remat and with TRPE, one layer in bf16 and f32, the
checkpoint, `TCDiff._sample` and the CLI under tp) and `dp_tp_cases` (a dp x tp step against one
process), `world_collectives` (the dp collectives on a mesh) and
`traced_train_steps` (each dp step's phase spans under a profiler).
Parameters, gradients and EMA entries come back whole, gathered
over the tp ranks where the state is split.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2  # the data-parallel ranks of the dp tests

# tests/test_sharded_long_sampling.py's sampler sizes
LONG_MODEL = dict(seq_len=8, latent_dim=32, ff_size=32, num_layers=1, num_heads=2, dancer_num=2, head_dim=16)
LONG_DIFF = dict(sampling_timesteps=4, n_timestep=10)
# tests/test_torch_train.py's train-step model
TRAIN_MODEL = dict(nfeats=151, seq_len=12, latent_dim=64, ff_size=64, num_layers=1, num_heads=4, dropout=0.0,
                   cond_feature_dim=16, dancer_num=2)
# tests/test_torch_traj_trainer.py's DBN
TRAJ = dict(window_size=8, step=4, trans_layer=2, latent_dim=16, n_head=2, dropout=0.0, lr=1e-3,
            total_iter=4, print_iter=2, batch_size=8, lr_milestones=(1,), gamma=0.5, seed=0)
# tests/_torch_tcdiff.py's TCDiff
TCDIFF_MODEL = dict(seq_len=16, latent_dim=32, ff_size=32, num_layers=1, num_heads=2, cond_feature_dim=438,
                    dancer_num=2, head_dim=16)
TCDIFF_DIFF = dict(sampling_timesteps=2, n_timestep=10, footwork_frames=(4, 12), footwork_blend_width=2)


def _rank_main(rank: int, case: str, store: str, out_dir: str, payload: dict, device: str, dp: int,
               tp: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(dp * tp), LOCAL_RANK=str(rank))
    torch.set_num_threads(2 if dp * tp <= 2 else 1)
    from tcdiff_torch.parallel.mesh import init_distributed, make_mesh

    dev = init_distributed(device, backend="gloo", init_method=store)
    try:
        result = globals()[case](make_mesh(dp, tp, device=dev), payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(case: str, tmp_dir, payload: dict, device: str = "cpu", dp: int = WORLD, tp: int = 1):
    """Start `case` on the dp x tp gloo ranks of a (dp, tp) mesh (each on
    `device`; an indexed CUDA device puts every rank on that card) and
    return at once, so that the caller computes its references meanwhile;
    `join_ranks` collects."""
    out = str(tmp_dir)
    store = "file://" + os.path.join(out, "store")
    ctx = mp.start_processes(_rank_main, args=(case, store, out, payload, device, dp, tp), nprocs=dp * tp,
                             join=False, start_method="spawn")
    return ctx, out, dp * tp


def join_ranks(started, timeout: float = 300.0) -> list:
    """Wait for the ranks `start_ranks` started; each rank's result, in
    rank order. A rank that raises or outlasts `timeout` s makes this
    raise (the others are then ended)."""
    ctx, out, world = started
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def run_ranks(case: str, tmp_dir, payload: dict, device: str = "cpu", dp: int = WORLD, tp: int = 1) -> list:
    """`start_ranks` then `join_ranks`."""
    return join_ranks(start_ranks(case, tmp_dir, payload, device, dp, tp))


def _whole(t, p):
    """t (a tensor of parameter p's shape) whole: gathered over the tp
    ranks where p is split (a collective every rank makes)."""
    from tcdiff_torch.parallel.sharding_rules import whole_tensor

    shard = getattr(p, "tp_shard", None)
    return t.detach().clone() if shard is None else whole_tensor(t.detach(), shard)


def _named(model) -> dict:
    return {n: _whole(p, p) for n, p in model.named_parameters()}


def _grads(model) -> dict:
    return {n: _whole(p.grad if p.grad is not None else torch.zeros_like(p), p) for n, p in model.named_parameters()}


def _ema(state) -> dict:
    params = dict(state.model.named_parameters())
    return {n: _whole(e, params[n]) for n, e in state.ema_params.items()}


def _scalars(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


# ------------------------------------------------------------------ training
def _device(mesh):
    return torch.device("cpu") if mesh is None else mesh.device


def _rows(arrays, mesh):
    """This rank's rows of each array (all of them with no mesh), as tensors."""
    from tcdiff_torch.parallel.mesh import shard_batch

    return tuple(torch.from_numpy(a).to(_device(mesh)) for a in (arrays if mesh is None else shard_batch(arrays, mesh)))


def _diffusion_step(model, mesh, dcfg, lr: float):
    """The train state (split over the mesh's tp ranks where tp > 1) and
    its train step."""
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
    from tcdiff_torch.optim.adan import Adan
    from tcdiff_torch.parallel.sharding_rules import shard_train_state
    from tcdiff_torch.train.state import create_train_state
    from tcdiff_torch.train.train_step import make_train_step

    opt = Adan(model.parameters(), lr=lr, weight_decay=0.02)
    diff = GaussianDiffusion(model, dcfg, device=_device(mesh))
    state = create_train_state(model, opt)
    if mesh is not None:
        shard_train_state(state, mesh)
    return state, make_train_step(diff, opt, ema_beta=0.9, ema_interval=1, device=_device(mesh), mesh=mesh)


def train_step_vs_jax(mesh, p: dict) -> dict:
    """Two dp steps from the JAX weights, fed the global t, noise and keep
    mask JAX's step drew; the metrics of both, the parameters and EMA after
    the first, the parameters after the second."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.interop.from_jax import load_jax_params
    from tcdiff_torch.models.dance_decoder import DanceDecoder

    model = load_jax_params(DanceDecoder(DanceDecoderConfig(**TRAIN_MODEL), device=mesh.device), p["params"])
    state, step = _diffusion_step(model, mesh, DiffusionConfig(cond_drop_prob=0.25), 1e-3)
    x, cond = _rows((p["x"], p["cond"]), mesh)
    out = {"metrics": []}
    for i, (t, noise, keep) in enumerate(p["draws"]):
        state, m = step(state, x, cond, t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                        keep_mask=torch.from_numpy(keep))
        out["metrics"].append(_scalars(m))
        if i == 0:
            out["params1"], out["ema1"] = _named(model), _ema(state)
    out["params2"], out["step"] = _named(model), state.step
    return out


def train_step_dropout(mesh, p: dict) -> dict:
    """Two steps at dropout 0.1, every draw from one generator of seed 7:
    the metrics and the (all-reduced) gradients of both steps, the
    parameters after each, the EMA after the second. mesh=None: one
    process, no mesh (the reference). p["remat"]: each layer recomputed in
    the backward."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.models.dance_decoder import DanceDecoder

    cfg = DanceDecoderConfig(**{**TRAIN_MODEL, "dropout": 0.1})
    model = DanceDecoder(cfg, device=_device(mesh), remat=p.get("remat", False)).init_random(
        torch.Generator().manual_seed(0))
    state, step = _diffusion_step(model, mesh, DiffusionConfig(cond_drop_prob=0.25), 1e-3)
    x, cond = _rows((p["x"], p["cond"]), mesh)
    gen = torch.Generator(device=_device(mesh)).manual_seed(7)
    out = {"metrics": [], "grads": [], "params": []}
    for _ in range(2):
        state, m = step(state, x, cond, gen)
        out["metrics"].append(_scalars(m))
        out["grads"].append(_grads(model))
        out["params"].append(_named(model))
    out["ema"] = _ema(state)
    return out


def traj_steps(mesh, p: dict) -> dict:
    """Two DBN steps at the window starts JAX's step drew: the metrics and
    gradients of both, the parameters after the second."""
    from tcdiff_torch.config import TrajDecoderConfig
    from tcdiff_torch.interop.from_jax import load_jax_traj_params
    from tcdiff_torch.trajdecoder.model import TrajDecoder
    from tcdiff_torch.trajdecoder.trainer import make_traj_optimizer, make_traj_train_step

    cfg = TrajDecoderConfig(**TRAJ)
    model = load_jax_traj_params(TrajDecoder(cfg, device=mesh.device), p["params"])
    opt, sched = make_traj_optimizer(model, cfg)
    step = make_traj_train_step(model, opt, sched, cfg, mesh)
    x, cond = _rows((p["x"], p["cond"]), mesh)
    out = {"metrics": [], "grads": []}
    for start in p["starts"]:
        out["metrics"].append(_scalars(step(x, cond, None, start=start)))
        out["grads"].append(_grads(model))
    out["params"], out["last_epoch"] = _named(model), sched.last_epoch
    return out


def cli_train_files(mesh, p: dict) -> dict:
    """`cli.train --mode train --dp 2 --device cpu` on synthetic data, the
    model shrunk as tests/test_torch_cli.py shrinks it; returns the files
    this rank opened for writing under the run's directories (an audit
    hook sees every `open`), its step count and checkpoints."""
    from tcdiff_torch.cli import args, train
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TrajDecoderConfig
    from tcdiff_torch.train import orchestrator as orch

    def config(opt):
        cfg = args.config_from_opt(opt)
        model = dataclasses.replace(DanceDecoderConfig(**TCDIFF_MODEL), dancer_num=cfg.model.dancer_num,
                                    seq_len=cfg.model.seq_len)
        return dataclasses.replace(cfg, model=model, diffusion=DiffusionConfig(**TCDIFF_DIFF),
                                   traj=TrajDecoderConfig(window_size=8, step=4, trans_layer=1, latent_dim=16))

    train.config_from_opt = config
    orch.MetricLogger = functools.partial(orch.MetricLogger, use_wandb=False, use_tensorboard=False)
    root = p["root"]
    written = []

    def audit(event, a):
        if event == "os.rename":  # os.replace too: the name a file is written under
            path, writes = a[1], True
        elif event == "open":
            path, mode, flags = a[0], a[1], a[2]
            writes = set(mode) & set("wax+") if mode else flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)
        else:
            return
        if writes and isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(root):
            written.append(os.path.relpath(os.path.abspath(path), root))

    sys.addaudithook(audit)
    runner = train.main(p["argv"])
    return {"written": sorted(set(written)), "step": runner.state.step, "dp": runner.mesh.world,
            "tp": runner.mesh.tp, "params": _named(runner.model)}


def train_cases(mesh, p: dict) -> dict:
    return {"jax": train_step_vs_jax(mesh, p["jax"]), "dropout": train_step_dropout(mesh, p["dropout"]),
            "traj": traj_steps(mesh, p["traj"]), "cli": cli_train_files(mesh, p["cli"])}


# ------------------------------------------------------------------ sampling
def _long_model(p: dict, device):
    """The long sampler's denoiser, of p["model"]'s sizes: p["params"]
    (flax weights, numpy), or random weights of seed p["seed"]."""
    from tcdiff_torch.config import DanceDecoderConfig
    from tcdiff_torch.interop.from_jax import load_jax_params
    from tcdiff_torch.models.dance_decoder import DanceDecoder

    model = DanceDecoder(DanceDecoderConfig(**p["model"]), device=device)
    if p.get("params") is None:
        return model.init_random(torch.Generator().manual_seed(p["seed"]))
    return load_jax_params(model, p["params"])


def long_sampler(mesh, p: dict) -> dict:
    """`long_ddim_sample_sharded` over the ranks at each slice count of
    p["cases"] (injected noise), and at 4 slices from a generator: this
    rank's slices and the gathered song."""
    from tcdiff_torch.config import DiffusionConfig
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
    from tcdiff_torch.parallel.comm import all_gather_rows

    diff = GaussianDiffusion(_long_model(p, mesh.device), DiffusionConfig(**LONG_DIFF), device=mesh.device)
    dev = lambda a: torch.from_numpy(a).to(mesh.device)
    out = {}
    for n, c in p["cases"].items():
        local = diff.long_ddim_sample_sharded(c["shape"], dev(c["cond"]), mesh, x_0=dev(c["x_0"]),
                                              noise={k: dev(v) for k, v in c["noise"].items()})
        out[n] = {"local": local.cpu(), "full": all_gather_rows(local, mesh).cpu()}
    c = p["cases"][4]
    gen = torch.Generator(device=mesh.device).manual_seed(3)
    local = diff.long_ddim_sample_sharded(c["shape"], dev(c["cond"]), mesh, generator=gen, x_0=dev(c["x_0"]))
    out["generator"] = all_gather_rows(local, mesh).cpu()
    return out


def tcdiff_sample(mesh, p: dict) -> dict:
    """Normal-mode `TCDiff._sample` over the ranks (dp = -1: the world),
    and inside `alone()` on each rank by itself."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TCDiffConfig, TrainConfig
    from tcdiff_torch.train.orchestrator import TCDiff

    cfg = TCDiffConfig(model=DanceDecoderConfig(**TCDIFF_MODEL), diffusion=DiffusionConfig(**TCDIFF_DIFF),
                       train=TrainConfig(batch_size=4))
    runner = TCDiff(cfg, device=mesh.device)
    gen = lambda: torch.Generator(device=mesh.device).manual_seed(5)
    sharded = runner._sample(p["cond"], p["x_0"], gen())
    with runner.alone():
        alone = runner._sample(p["cond"], p["x_0"], gen())
    return {"dp": runner.mesh.world, "sharded": sharded.cpu(), "alone": alone.cpu()}


def sample_cases(mesh, p: dict) -> dict:
    return {"long": long_sampler(mesh, p["long"]), "tcdiff": tcdiff_sample(mesh, p["tcdiff"])}


def long_sampler_plain(p: dict, device="cpu") -> dict:
    """The one-process references of `long_sampler`: `long_ddim_sample`
    at each case, and at 4 slices from the same generator seed."""
    from tcdiff_torch.config import DiffusionConfig
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion

    diff = GaussianDiffusion(_long_model(p, device), DiffusionConfig(**LONG_DIFF), device=device)
    dev = lambda a: torch.from_numpy(a).to(device)
    out = {n: diff.long_ddim_sample(c["shape"], dev(c["cond"]), x_0=dev(c["x_0"]),
                                    noise={k: dev(v) for k, v in c["noise"].items()}).cpu()
           for n, c in p["cases"].items()}
    c = p["cases"][4]
    out["generator"] = diff.long_ddim_sample(c["shape"], dev(c["cond"]), torch.Generator(device=device).manual_seed(3),
                                             x_0=dev(c["x_0"])).cpu()
    return out


def long_payload(params, slice_counts=(4, 2), seed: int = 0, model: dict = LONG_MODEL) -> dict:
    """Seeded inputs of the long sampler at each slice count (numpy), for
    a denoiser of `model`'s sizes; params None: random weights of `seed`."""
    tokens, nf = model["seq_len"] * model["dancer_num"], 151
    rng = np.random.default_rng(seed)
    cases = {}
    for n in slice_counts:
        shape = (n, tokens, nf)
        cases[n] = {"shape": shape,
                    "cond": rng.normal(size=(n, 2 * model["seq_len"] + 1, 438)).astype(np.float32),
                    "x_0": (rng.normal(size=(n, tokens, 3)) * 0.2).astype(np.float32),
                    "noise": {"init": rng.normal(size=shape).astype(np.float32),
                              "steps": rng.normal(size=(LONG_DIFF["sampling_timesteps"],) + shape).astype(np.float32)}}
    return {"params": params, "seed": seed, "model": model, "cases": cases}


# -------------------------------------------------------- tensor parallelism
def trpe_loss(mesh, p: dict) -> dict:
    """One loss and backward at dropout 0.1 with a trj_dist (TRPE), every
    draw from one generator of seed 7: the loss terms and the whole
    gradients. mesh=None: one process."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
    from tcdiff_torch.models.dance_decoder import DanceDecoder

    model = DanceDecoder(DanceDecoderConfig(**{**TRAIN_MODEL, "dropout": 0.1}), device=_device(mesh)).init_random(
        torch.Generator().manual_seed(0))
    _diffusion_step(model, mesh, DiffusionConfig(cond_drop_prob=0.25), 1e-3)  # splits the weights under tp
    diff = GaussianDiffusion(model, DiffusionConfig(cond_drop_prob=0.25), device=_device(mesh))
    x, cond, trj = _rows((p["x"], p["cond"], p["trj"]), mesh)
    rows = None if mesh is None else mesh.rows(x.shape[0] * mesh.world)
    total, parts = diff.loss(x, cond, torch.Generator().manual_seed(7), rows=rows, trj_dist=trj)
    total.backward()
    return {"metrics": _scalars({**parts, "total": total}), "grads": _grads(model)}


def tp_checkpoint(mesh, p: dict) -> dict:
    """Two steps at dropout 0.1 (as `train_step_dropout`), then
    `save_checkpoint` on every rank (rank 0 writes, the state gathered):
    the gathered state, and the same file restored into a new whole state
    and split over the mesh (as `TCDiff` loads one), gathered."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.models.dance_decoder import DanceDecoder
    from tcdiff_torch.parallel.sharding_rules import gather_train_state, shard_train_state
    from tcdiff_torch.utils.checkpoint import restore_train_state, save_checkpoint

    cfg = DanceDecoderConfig(**{**TRAIN_MODEL, "dropout": 0.1})
    dcfg = DiffusionConfig(cond_drop_prob=0.25)
    model = DanceDecoder(cfg, device=mesh.device).init_random(torch.Generator().manual_seed(0))
    state, step = _diffusion_step(model, mesh, dcfg, 1e-3)
    x, cond = _rows((p["x"], p["cond"]), mesh)
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        state, _ = step(state, x, cond, gen)
    path = save_checkpoint(p["dir"], state.step, state)
    whole = gather_train_state(state)
    other = DanceDecoder(cfg, device=mesh.device).init_random(torch.Generator().manual_seed(1))
    again, _ = _diffusion_step(other, None, dcfg, 1e-3)
    restored, _ = restore_train_state(path, again)
    shard_train_state(restored, mesh)
    return {"path": path, "step": state.step, "whole": whole, "restored": gather_train_state(restored),
            "restored_step": restored.step}


def tp_tcdiff_sample(mesh, p: dict) -> dict:
    """Normal-mode `TCDiff._sample` of a TCDiff of cfg.train.tp = the
    mesh's: its split model's parameter count a rank and the sample (from
    the whole serving model of the gathered weights)."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TCDiffConfig, TrainConfig
    from tcdiff_torch.train.orchestrator import TCDiff

    cfg = TCDiffConfig(model=DanceDecoderConfig(**TCDIFF_MODEL), diffusion=DiffusionConfig(**TCDIFF_DIFF),
                       train=TrainConfig(batch_size=4, tp=mesh.tp))
    runner = TCDiff(cfg, device=mesh.device)
    sample = runner._sample(p["cond"], p["x_0"], torch.Generator(device=mesh.device).manual_seed(5))
    return {"dp": runner.mesh.world, "tp": runner.mesh.tp, "held": sum(q.numel() for q in runner.model.parameters()),
            "sample": sample.cpu()}


def world_collectives(mesh, p: dict) -> dict:
    """One data-parallel gradient all-reduce and one metric mean on the
    mesh: whether its dp group is the world's, the results and the
    collectives issued (`parallel.comm.collective_counts`)."""
    from tcdiff_torch.parallel.comm import all_reduce_grads_, all_reduce_mean, collective_counts

    grads = [torch.full((3,), 2.0), torch.ones(2, 2)]
    all_reduce_grads_(grads, mesh)
    mean = all_reduce_mean({"loss": torch.tensor(1.5)}, mesh)
    return {"world_group": mesh.group is dist.group.WORLD, "grads": grads, "loss": float(mean["loss"]),
            "counts": collective_counts()}


def tp_layer(mesh, p: dict) -> dict:
    """Decoder layer 0 and final_layer of the train model at dropout 0.1,
    forward and backward in p["dtype"] on a seeded batch and cotangent: on
    the mesh (the state split over its tp ranks) or, mesh=None, in one
    process. The output and the gradients of x, the memory, t and every
    parameter, whole."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.models.dance_decoder import DanceDecoder, _lin

    dtype = getattr(torch, p["dtype"])
    cfg = DanceDecoderConfig(**{**TRAIN_MODEL, "dropout": 0.1})
    model = DanceDecoder(cfg, dtype=dtype, device=_device(mesh)).init_random(torch.Generator().manual_seed(0))
    _diffusion_step(model, mesh, DiffusionConfig(), 1e-3)  # splits the state over the tp ranks
    layer = model.layers[0]
    g = torch.Generator().manual_seed(3)
    d = cfg.latent_dim
    x, mem, t = (torch.randn(shape, generator=g).to(dtype).requires_grad_()
                 for shape in ((4, cfg.tokens, d), (4, 2 * cfg.seq_len + 1, d), (4, d)))
    draws = layer.train_draws(g, x.shape, cfg.dropout)
    out = _lin(model.final_layer, layer.forward_train(x, mem, t, None, draws, cfg.dropout,
                                                      mesh=model.tp_mesh)).float()
    (out * torch.randn(out.shape, generator=g)).sum().backward()
    return {"out": out.detach(), "dx": x.grad.float(), "dmem": mem.grad.float(), "dt": t.grad.float(),
            **{n: v.float() for n, v in _grads(model).items()}}


def tp_cases(mesh, p: dict) -> dict:
    return {"layer_bf16": tp_layer(mesh, {"dtype": "bfloat16"}), "layer_f32": tp_layer(mesh, {"dtype": "float32"}),"jax": train_step_vs_jax(mesh, p["jax"]), "dropout": train_step_dropout(mesh, p["dropout"]),
            "remat": train_step_dropout(mesh, {**p["dropout"], "remat": True}), "trpe": trpe_loss(mesh, p["trpe"]),
            "ckpt": tp_checkpoint(mesh, p["ckpt"]), "tcdiff": tp_tcdiff_sample(mesh, p["tcdiff"]),
            "cli": cli_train_files(mesh, p["cli"])}


def dp_tp_cases(mesh, p: dict) -> dict:
    return {"dropout": train_step_dropout(mesh, p["dropout"])}


# ------------------------------------------------------------------- tracing
def traced_train_steps(mesh, p: dict) -> dict:
    """p["steps"] dp train steps at dropout 0.1 under a CPU torch.profiler
    session: the names of each step's phase spans, in order."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig
    from tcdiff_torch.models.dance_decoder import DanceDecoder
    from tcdiff_torch.utils.profiling import TRACER

    model = DanceDecoder(DanceDecoderConfig(**{**TRAIN_MODEL, "dropout": 0.1}), device=_device(mesh)).init_random(
        torch.Generator().manual_seed(0))
    state, step = _diffusion_step(model, mesh, DiffusionConfig(cond_drop_prob=0.25), 1e-3)
    rng = np.random.default_rng(5)
    x, cond = _rows(((rng.normal(size=(4, 2, 12, 151)) * 0.3).astype(np.float32),
                     rng.normal(size=(4, 25, 16)).astype(np.float32)), mesh)
    gen = torch.Generator().manual_seed(7)
    TRACER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(p["steps"]):
            state, _ = step(state, x, cond, gen)
    return {"phases": [[s.name for s in r.spans if s.parent == r.record.id] for r in TRACER.roots("train.step")]}
