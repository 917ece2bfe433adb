"""Tensor parallelism in the port against the JAX package's tp mesh and
against one process, on the CPU with gloo ranks.

The ranks are spawned once for the file (`tests/_torch_parallel.py`): two
ranks of a (dp, tp) = (1, 2) mesh run `tp_cases`, four of a (2, 2) mesh
`dp_tp_cases`; the JAX references and the one-process ones run here while
they do. Cases:

  * (a) at full width (`DanceDecoderConfig(dancer_num=3)`), for every
    parameter: rank j's slice at tp = 2, of the parameter, of its EMA
    entry and of each of its Adan moments (`shard_train_state`), equals
    shard j of JAX's `params_pspecs` placement of the same leaf (device_put
    on a (1, 2) mesh of the 8-device CPU mesh), mapped by
    `params_to_state_dict`; the leaves' values are their element indices,
    so a slice from the wrong place shows; a rank holds 30,815,537 of the
    61,428,181 parameters;
  * (b) the tp = 2 train step against JAX's `make_train_step` on
    `make_mesh(dp=1, tp=2)` with JAX's `shard_train_state`,
    tests/test_torch_train.py's model at dropout 0, the port fed the t,
    noise and keep mask JAX's step draws: tests/test_tensor_parallel.py's
    tolerances (the loss at rtol 2e-5, the parameters after a step at
    rtol 5e-4 and atol 5e-6), the gradient norm at the dp test's 3e-4;
  * (c) tp = 2 and dp = 2 x tp = 2 against the port's one process at
    dropout 0.1 over two steps, at tests/test_torch_parallel_train.py's
    rules (the loss terms 1e-5, the parameters after step 1 within 1e-6,
    after step 2 at most 5% of a tensor's elements more than lr/10 apart)
    but every gradient within GRAD_TOL, twice that file's 3e-5, of its
    tensor's largest value (see GRAD_TOL); with remat,
    the same against one process without it; with a trj_dist (TRPE) one
    loss and backward at the same rules; every rank's whole state
    bit-identical;
  * (d) a checkpoint written at tp = 2 (every rank gathers, rank 0 writes)
    loads at tp = 1 and at tp = 2, each equal to the tp = 2 state gathered,
    bit for bit;
  * (e) `TCDiff._sample` with cfg.train.tp = 2 (a whole serving model of
    the gathered weights) within 1e-5 of one process's, as the dp sample
    test holds it (the ranks' CPU products run on fewer threads than this
    process's, which moves f32 sums; on the card chip_smoke.py holds it
    bit for bit);
  * (f) `cli.train --mode train --tp 2 --device cpu` over two gloo ranks:
    rank 0 writes the checkpoint (whole tensors) and metrics.jsonl, rank 1
    nothing;
  * a tp that does not divide the heads raises ValueError with the
    numbers;
  * a joined world of one keeps its dp group: the step's collectives run;
  * decoder layer 0 and final_layer at tp = 2, forward and backward, in
    bf16 and f32, against one process (LAYER_TOL of each tensor's norm):
    the check of the split's bf16 arithmetic, which a whole step's bf16
    roundings would hide.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

import _torch_parallel as tp  # noqa: E402
import test_torch_parallel_train as dp_tests  # noqa: E402
from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.optim import adan as jax_adan  # noqa: E402
from tcdiff_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tcdiff_tpu.parallel import params_pspecs, replicated, shard_batch  # noqa: E402
from tcdiff_tpu.parallel import shard_train_state as jax_shard_train_state  # noqa: E402
from tcdiff_tpu.train import create_train_state as jax_create_state  # noqa: E402
from tcdiff_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TCDiffConfig, TrainConfig  # noqa: E402
from tcdiff_torch.interop.from_jax import params_to_state_dict  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.parallel.mesh import Mesh  # noqa: E402
from tcdiff_torch.parallel.sharding_rules import param_splits, shard_train_state  # noqa: E402
from tcdiff_torch.train.orchestrator import TCDiff  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.utils.checkpoint import restore_train_state  # noqa: E402

TP = 2
BS = dp_tests.BS
LR = dp_tests.LR
# tp against one process: each split product adds its ranks' partial sums
# in another order than one process's GEMM, so the f32 roundings reach
# further than dp's alone. On this file's payload (seed 11) the worst
# gradient is final_layer's at step 2, 3.2e-5 of its largest value (dp = 2
# alone: 1.9e-5, at step 1). Over the payloads of seeds 11 and 1-5
# (tests/_torch_parallel_readings.py) the worst step-1 gradient read up to
# 4.2e-5 at tp = 2 and 4.8e-5 at dp = 2 x tp = 2 against dp = 2's 2.3e-5 on
# the same payloads, and at step 2, after Adan's sign-like first update, up
# to 9.2e-5 and 6.8e-5 against dp's 1.9e-4: the same order as dp's. The
# gradients are held to twice dp's rule; the loss terms and the parameters
# to dp's own.
GRAD_TOL = 2 * dp_tests.GRAD_TOL
PORT_TOL = 1e-5  # tests/test_torch_parallel_sample.py's: sampling, ranks against one process
# one layer against one process, relative to each tensor's norm: bf16
# reads 1.75e-3 at its worst (dt), and 9.0e-3 with `mm_whole`'s tp_copy
# moved to the bf16 side of its cast (the ranks' partial input gradients
# rounded before they are summed); f32 7.4e-7
LAYER_TOL = {"bf16": 4e-3, "f32": 1e-5}
FULL = dict(dancer_num=3)  # the full-width model: 8 layers, d = 512, 8 heads
FULL_PARAMS, FULL_PER_RANK = 61_428_181, 30_815_537


def _fake_mesh(j: int) -> Mesh:
    """Rank j's tp = 2 mesh, without a group: splitting calls no collective."""
    return Mesh(0, 1, torch.device("cpu"), None, j, TP, None)


def _jax_shard(values, spec, mesh, j: int) -> np.ndarray:
    """Shard j of `values` placed on the (1, 2) mesh under `spec`."""
    arr = jax.device_put(values, NamedSharding(mesh, spec))
    dev = mesh.devices[0, j]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


@pytest.mark.parametrize("j", [0, 1])
def test_every_split_is_jax_pspecs_shard_at_full_width(j):
    jcfg = JaxDecoderConfig(**FULL)
    shapes = jax.eval_shape(JaxDecoder(jcfg).init, jax.random.key(0), jnp.zeros((1, jcfg.tokens, jcfg.nfeats)),
                            jnp.zeros((1, 2 * jcfg.seq_len + 1, jcfg.cond_feature_dim)),
                            jnp.zeros((1,), jnp.int32))["params"]
    values = jax.tree.map(lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(s.shape), shapes)
    specs = params_pspecs(values, tp=TP)
    mesh = jax_make_mesh(dp=1, tp=TP)
    want = params_to_state_dict(jax.tree.map(lambda v, s: _jax_shard(v, s, mesh, j), values, specs),
                                jcfg.num_layers, jcfg.latent_dim)

    model = DanceDecoder(DanceDecoderConfig(**FULL), device="cpu")
    whole = params_to_state_dict(values, jcfg.num_layers, jcfg.latent_dim)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in whole.items()})
    del whole, values
    opt = Adan(model.parameters(), lr=LR)
    state = create_train_state(model, opt)
    for p in model.parameters():  # the moments: the parameter's values, as a check of where each slice comes from
        opt.state[p] = {k: p.detach().clone() for k in ("m", "v", "n", "prev_grad")}
    shard_train_state(state, _fake_mesh(j))
    held = 0
    for name, p in model.named_parameters():
        ref = torch.from_numpy(np.ascontiguousarray(want[name]))
        assert torch.equal(p.detach(), ref), name
        assert torch.equal(state.ema_params[name], ref), name
        for k, t in opt.state[p].items():
            assert torch.equal(t, ref), (name, k)
        held += p.numel()
    assert sum(v.size for k, v in want.items() if k in state.ema_params) == held == FULL_PER_RANK
    meta = DanceDecoder(DanceDecoderConfig(**FULL), device="meta")
    splits = param_splits(meta, TP)
    assert sum(q.numel() for q in meta.parameters()) == FULL_PARAMS
    assert sum(q.numel() // (TP if splits[n] is not None else 1) for n, q in meta.named_parameters()) == FULL_PER_RANK


def test_a_tp_that_does_not_divide_the_heads_raises():
    model = DanceDecoder(DanceDecoderConfig(**tp.TRAIN_MODEL), device="cpu")
    state = create_train_state(model, Adan(model.parameters(), lr=LR))
    with pytest.raises(ValueError, match="tp=3 does not divide the 4 attention heads"):
        shard_train_state(state, Mesh(0, 1, torch.device("cpu"), None, 0, 3, None))


def test_a_joined_world_of_one_keeps_its_dp_group(tmp_path):
    """torchrun --nproc_per_node 1 joins a world of one: its mesh keeps the
    world's group on the dp axis (none on tp), so the step's all-reduce and
    metric mean run over the backend, as they do in a larger world."""
    (got,) = tp.run_ranks("world_collectives", tmp_path, {}, dp=1, tp=1)
    assert got["world_group"]
    assert torch.equal(got["grads"][0], torch.full((3,), 2.0)) and torch.equal(got["grads"][1], torch.ones(2, 2))
    assert got["loss"] == 1.5
    assert got["counts"] == {"all_reduce_grads_ gloo": 1, "all_reduce_mean gloo": 1}


def _jax_tp_train(p):
    """JAX's state and metrics after each of two steps on a (1, 2) mesh,
    its state split by its `shard_train_state`."""
    mesh = jax_make_mesh(dp=1, tp=TP)
    tx = jax_adan(LR, weight_decay=0.02)
    jstate = jax_shard_train_state(jax_create_state(p["params"], tx), mesh)
    jstep = jax.jit(jax_make_train_step(JaxDiffusion(JaxDecoder(dp_tests.JMCFG), dp_tests.JDCFG), tx,
                                        ema_beta=0.9, ema_interval=1))
    xs, cs = shard_batch((jnp.asarray(p["x"]), jnp.asarray(p["cond"])), mesh)
    key = jax.device_put(jax.random.key(5), replicated(mesh))
    states = []
    for _ in range(2):
        jstate, jm = jstep(jstate, xs, cs, key)
        states.append((jax.tree.map(np.asarray, jstate), {k: float(v) for k, v in jm.items()}))
    return states


def _payload(rng, model: dict):
    tokens = model["seq_len"] * model["dancer_num"]
    return {"x": (rng.normal(size=(BS, model["dancer_num"], model["seq_len"], 151)) * 0.3).astype(np.float32),
            "cond": rng.normal(size=(BS, 2 * model["seq_len"] + 1, model["cond_feature_dim"])).astype(np.float32),
            "trj": rng.integers(0, 10, size=(BS, tokens, tokens)).astype(np.int64)}


def _tcdiff_lone(p):
    cfg = TCDiffConfig(model=DanceDecoderConfig(**tp.TCDIFF_MODEL), diffusion=DiffusionConfig(**tp.TCDIFF_DIFF),
                       train=TrainConfig(batch_size=4))
    return TCDiff(cfg, device="cpu")._sample(p["cond"], p["x_0"], torch.Generator().manual_seed(5))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    jax_payload = dp_tests._train_payload()
    rng = np.random.default_rng(11)
    dropout = _payload(rng, tp.TRAIN_MODEL)
    m = tp.TCDIFF_MODEL
    tcdiff = {"cond": rng.normal(size=(4, 2 * m["seq_len"] + 1, 438)).astype(np.float32),
              "x_0": (rng.normal(size=(4, m["seq_len"] * m["dancer_num"], 3)) * 0.2).astype(np.float32)}
    root = str(tmp_path_factory.mktemp("cli"))
    argv = ["--mode", "train", "--tp", "2", "--synthetic", "--synthetic_size", "8", "--device", "cpu",
            "--window_size", "16", "--required_dancer_num", "2", "--project", f"{root}/runs", "--exp_name", "t",
            "--render_dir", f"{root}/renders", "--no_render", "--epochs", "1", "--save_interval", "1",
            "--batch_size", "4"]
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    payload = {"jax": jax_payload, "dropout": dropout, "trpe": dropout, "ckpt": {**dropout, "dir": ckpt_dir},
               "tcdiff": tcdiff, "cli": {"root": root, "argv": argv}}
    started = tp.start_ranks("tp_cases", tmp_path_factory.mktemp("ranks"), payload, dp=1, tp=TP)
    started4 = tp.start_ranks("dp_tp_cases", tmp_path_factory.mktemp("ranks4"), {"dropout": dropout}, dp=2, tp=TP)
    # the references, while the ranks run
    refs = {"jax": _jax_tp_train(jax_payload), "lone": tp.train_step_dropout(None, dropout),
            "layer_bf16": tp.tp_layer(None, {"dtype": "bfloat16"}), "layer_f32": tp.tp_layer(None, {"dtype": "float32"}),
            "trpe": tp.trpe_loss(None, dropout), "tcdiff": _tcdiff_lone(tcdiff)}
    return {"ranks": tp.join_ranks(started), "ranks4": tp.join_ranks(started4), "cli_root": root, **refs}


def _by_name(tree):
    return params_to_state_dict(tree, dp_tests.JMCFG.num_layers, dp_tests.JMCFG.latent_dim)


def test_tp_train_step_matches_jax_tp_mesh(run):
    (s1, m1), (_, m2) = run["jax"]
    for r, res in enumerate(run["ranks"]):
        got = res["jax"]
        assert got["step"] == 2
        for i, jm in enumerate((m1, m2)):
            np.testing.assert_allclose(got["metrics"][i]["total"], jm["total"], rtol=2e-5, err_msg=f"{r} {i}")
            np.testing.assert_allclose(got["metrics"][i]["grad_norm"], jm["grad_norm"], rtol=3e-4,
                                       err_msg=f"{r} {i}")
        ref_p, ref_e = _by_name(s1.params), _by_name(s1.ema_params)
        for name, p in got["params1"].items():
            np.testing.assert_allclose(p.numpy(), ref_p[name], rtol=5e-4, atol=5e-6, err_msg=name)
            np.testing.assert_allclose(got["ema1"][name].numpy(), ref_e[name], rtol=5e-4, atol=5e-6, err_msg=name)


def _assert_matches_one_process(got, lone, step: int, where):
    for k, v in lone["metrics"][step].items():
        assert abs(got["metrics"][step][k] - v) <= 1e-5 * max(abs(v), 1e-12), (where, step, k)
    for name, ref in lone["grads"][step].items():
        scale = ref.abs().max().item()
        assert (got["grads"][step][name] - ref).abs().max().item() <= GRAD_TOL * scale, (where, step, name)
    if step == 0:
        for name, ref in lone["params"][0].items():
            assert (got["params"][0][name] - ref).abs().max().item() <= 1e-6, (where, name)
    else:
        for name, ref in lone["params"][1].items():
            off = ((got["params"][1][name] - ref).abs() > LR / 10).float().mean().item()
            assert off <= 0.05, (where, name, off)


@pytest.mark.parametrize("mesh", ["tp2", "dp2xtp2"])
@pytest.mark.parametrize("step", [0, 1])
def test_tp_matches_one_process_at_dropout(run, mesh, step):
    ranks = run["ranks"] if mesh == "tp2" else run["ranks4"]
    for r, res in enumerate(ranks):
        _assert_matches_one_process(res["dropout"], run["lone"], step, (mesh, r))


@pytest.mark.parametrize("step", [0, 1])
def test_tp_with_remat_matches_one_process(run, step):
    for r, res in enumerate(run["ranks"]):
        _assert_matches_one_process(res["remat"], run["lone"], step, ("remat", r))


def test_tp_trpe_loss_matches_one_process(run):
    lone = run["trpe"]
    for r, res in enumerate(run["ranks"]):
        got = res["trpe"]
        for k, v in lone["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-12), (r, k)
        for name, ref in lone["grads"].items():
            assert (got["grads"][name] - ref).abs().max().item() <= GRAD_TOL * ref.abs().max().item(), (r, name)
        assert got["grads"]["embeddings_table.weight"].abs().max() > 0  # the TRPE table trains, in its slices


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_tp_layer_matches_one_process(run, dtype):
    """One decoder layer and final_layer, forward and backward: the output
    and every gradient within LAYER_TOL of its norm (a zeroed gradient
    reads 1, a flipped one 2)."""
    lone = run[f"layer_{dtype}"]
    for r, res in enumerate(run["ranks"]):
        got = res[f"layer_{dtype}"]
        assert got.keys() == lone.keys()
        for name, ref in lone.items():
            err = (got[name] - ref).norm().item()
            assert err <= LAYER_TOL[dtype] * ref.norm().item(), (r, name, err / max(ref.norm().item(), 1e-30))


def test_tp_ranks_hold_bit_identical_state(run):
    for ranks, cases in ((run["ranks"], ("dropout", "remat")), (run["ranks4"], ("dropout",))):
        for case in cases:
            dp_tests._assert_same_on_every_rank(ranks, lambda r: r[case]["params"][1])
            dp_tests._assert_same_on_every_rank(ranks, lambda r: r[case]["ema"])
            dp_tests._assert_same_on_every_rank(ranks, lambda r: r[case]["grads"][1])
    dp_tests._assert_same_on_every_rank(run["ranks"], lambda r: r["cli"]["params"])


def _whole_state(model_cfg: dict):
    model = DanceDecoder(DanceDecoderConfig(**model_cfg), device="cpu")
    return create_train_state(model, Adan(model.parameters(), lr=LR, weight_decay=0.02))


def test_tp_checkpoint_loads_at_tp_1(run):
    got = run["ranks"][0]["ckpt"]
    whole = got["whole"]
    assert got["step"] == got["restored_step"] == 2
    state, _ = restore_train_state(got["path"], _whole_state({**tp.TRAIN_MODEL, "dropout": 0.1}))
    assert state.step == 2
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), whole["params"][name]), name
        assert torch.equal(state.ema_params[name], whole["ema"][name]), name
    loaded = state.optimizer.state_dict()
    for restored in (loaded, got["restored"]["optimizer"]):
        assert restored["param_groups"][0]["step"] == 2
        for i, st in whole["optimizer"]["state"].items():
            for k, t in st.items():
                assert torch.equal(restored["state"][i][k], t), (i, k)
    for part in ("params", "ema"):
        for name, t in whole[part].items():
            assert torch.equal(got["restored"][part][name], t), (part, name)
    assert run["ranks"][1]["ckpt"]["path"] == got["path"]


def test_tcdiff_sample_at_tp_matches_one_process(run):
    meta = DanceDecoder(DanceDecoderConfig(**tp.TCDIFF_MODEL), device="meta")
    splits = param_splits(meta, TP)
    held = sum(q.numel() // (TP if splits[n] is not None else 1) for n, q in meta.named_parameters())
    for r, res in enumerate(run["ranks"]):
        got = res["tcdiff"]
        assert (got["dp"], got["tp"], got["held"]) == (1, TP, held), r
        err = (got["sample"] - run["tcdiff"]).abs().max().item()
        assert err <= PORT_TOL, (r, err)


def test_cli_tp_train_writes_whole_files_on_rank_0_only(run):
    rank0, rank1 = (r["cli"] for r in run["ranks"])
    assert (rank0["dp"], rank0["tp"]) == (rank1["dp"], rank1["tp"]) == (1, TP)
    assert rank0["step"] == rank1["step"] == 2
    final = [f for f in rank0["written"] if not f.endswith(".tmp")]
    assert [f for f in final if f.endswith(".pt")] == ["runs/t/checkpoints/ckpt_2.pt"]
    assert [f for f in final if f.endswith("metrics.jsonl")] == ["runs/t/metrics.jsonl"]
    assert rank1["written"] == []
    ckpt = torch.load(f"{run['cli_root']}/runs/t/checkpoints/ckpt_2.pt", map_location="cpu", weights_only=False)
    for name, t in rank0["params"].items():  # whole tensors, the last step's parameters
        assert torch.equal(ckpt["model_state_dict"][name], t), name
