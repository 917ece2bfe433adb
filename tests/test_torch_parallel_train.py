"""Data-parallel training in the port against the JAX package's dp mesh
and against one process, on the CPU with two gloo ranks.

The ranks are spawned once for the file (`tests/_torch_parallel.py`,
`train_cases`); the JAX references run here on the 8-device CPU mesh of
tests/conftest.py (`make_mesh(dp=2)`). Cases:

  * the dp = 2 train step against JAX's `make_train_step` on a dp = 2
    mesh, tests/test_torch_train.py's model at dropout 0, the port fed the
    global t, noise and keep mask JAX's step draws, each rank keeping its
    rows: the tolerances of `test_train_step_matches_jax_make_train_step`
    (metrics 3e-4, parameters and EMA after step 1 3e-5 abs / 3e-4 rel);
  * dp = 2 against the port's one process at dropout 0.1 on one generator
    seed, two steps (the draws made at the global batch): the loss terms
    within 1e-5 and every gradient of both steps within GRAD_TOL (3e-5)
    of each tensor's largest value (the mean of two half-batch means
    against one mean: f32 rounding), the parameters after step 1 within 1e-6, after step 2 the
    two-step rule of ROADMAP queue 3 (at most 5% of a tensor's elements
    more than lr/10 apart: Adan's second update divides by a root that
    nearly vanishes for a few elements); both ranks' parameters and EMA
    bit-identical;
  * two DBN steps at dp = 2 against `make_traj_train_step` on a dp = 2
    mesh, with `test_two_steps_match_make_traj_train_step`'s tolerances;
  * `cli.train --mode train --dp 2 --device cpu`: rank 0 writes one
    checkpoint and one metrics.jsonl, rank 1 writes nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parallel as tp  # noqa: E402
from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.config import TrajDecoderConfig as JaxTrajConfig  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.optim import adan as jax_adan  # noqa: E402
from tcdiff_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tcdiff_tpu.parallel import replicated, shard_batch  # noqa: E402
from tcdiff_tpu.train import create_train_state as jax_create_state  # noqa: E402
from tcdiff_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from tcdiff_tpu.trajdecoder import trainer as jtrainer  # noqa: E402
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder  # noqa: E402
from tcdiff_torch.interop.from_jax import params_to_state_dict, traj_params_to_state_dict  # noqa: E402

BS, S = 4, 20  # the global batch (2 rows a rank); the DBN's sequence length
JMCFG = JaxDecoderConfig(**tp.TRAIN_MODEL)
JDCFG = JaxDiffusionConfig(cond_drop_prob=0.25)
JTCFG = JaxTrajConfig(**tp.TRAJ)
LR = 1e-3
# dp = 2 against one process: the gradient of a mean of two half-batch
# means, summed over the ranks, against one mean over the batch. The sums
# run in another order; where a tensor's gradient adds terms of both signs
# over the rows (null_cond_embed: only the rows whose condition is dropped)
# the rounding reaches 1.0e-5 of its largest element, so the gradients are
# held to the f32 gradient tolerance of tests/test_torch_train.py, 3e-5.
GRAD_TOL = 3e-5


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def _train_payload():
    """The train-step case's inputs: perturbed flax weights, the batch, and
    the t, noise and keep mask of each of JAX's two steps (its draws:
    train_step.py, gaussian.py::loss/p_losses)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(BS, JMCFG.dancer_num, JMCFG.seq_len, 151)) * 0.3).astype(np.float32)
    x[..., :4] = rng.uniform(0.5, 1.5, size=x[..., :4].shape).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * JMCFG.seq_len + 1, 16)).astype(np.float32)
    params = jax.jit(JaxDecoder(JMCFG).init)(jax.random.key(0), jnp.zeros((1, JMCFG.tokens, 151)),
                                             jnp.zeros((1, 2 * JMCFG.seq_len + 1, 16)),
                                             jnp.zeros((1,), jnp.int32))["params"]
    draws = []
    for i in range(2):
        k_t, k_rest = jax.random.split(jax.random.fold_in(jax.random.key(5), i))
        t = jax.random.randint(k_t, (BS,), 0, JDCFG.n_timestep)
        k_noise, k_keep, _ = jax.random.split(k_rest, 3)
        noise = jax.random.normal(k_noise, (BS, JMCFG.seq_len, JMCFG.dancer_num, 151), jnp.float32)
        keep = jax.random.bernoulli(k_keep, 1.0 - JDCFG.cond_drop_prob, (BS,))
        draws.append((np.asarray(t), np.asarray(noise), np.asarray(keep)))
    return {"params": _perturbed(params, 9), "x": x, "cond": cond, "draws": draws}


def _jax_train(p, mesh):
    """JAX's state and metrics after each of two steps on `mesh`."""
    jmodel = JaxDecoder(JMCFG)
    tx = jax_adan(LR, weight_decay=0.02)
    jstate = jax.device_put(jax_create_state(p["params"], tx), replicated(mesh))
    jstep = jax.jit(jax_make_train_step(JaxDiffusion(jmodel, JDCFG), tx, ema_beta=0.9, ema_interval=1))
    xs, cs = shard_batch((jnp.asarray(p["x"]), jnp.asarray(p["cond"])), mesh)
    key = jax.device_put(jax.random.key(5), replicated(mesh))
    states = []
    for _ in range(2):
        jstate, jm = jstep(jstate, xs, cs, key)
        states.append((jax.tree.map(np.asarray, jstate), {k: float(v) for k, v in jm.items()}))
    return states


def _jax_start(rng, step: int) -> int:
    """The window start JAX's DBN step draws at `step`."""
    win_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    return int(jax.random.randint(win_rng, (), 0, S - JTCFG.window_size - JTCFG.step))


def _traj_payload():
    """The DBN case's inputs: perturbed flax weights, the batch and the
    window start of each of JAX's two steps."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(BS, 3, S, 3)) * 0.5).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * S + 1, JTCFG.cond_feature_dim)).astype(np.float32)
    params = jax.jit(JaxTrajDecoder(JTCFG).init)(
        jax.random.key(0), jnp.zeros((1, 3, JTCFG.window_size, 2)),
        jnp.zeros((1, 2 * (JTCFG.window_size + JTCFG.step), JTCFG.cond_feature_dim)))["params"]
    return {"params": _perturbed(params, 7), "x": x, "cond": cond,
            "starts": [_jax_start(jax.random.key(3), i) for i in range(2)]}


def _jax_traj(p, mesh):
    """JAX's gradients and metrics of both DBN steps on `mesh`, and its
    parameters after the second."""
    jm = JaxTrajDecoder(JTCFG)
    params, x, cond = p["params"], p["x"], p["cond"]
    tx = jtrainer.make_traj_optimizer(JTCFG)
    jstate = jax.device_put(jax_create_state(params, tx), replicated(mesh))
    jstep = jax.jit(jtrainer.make_traj_train_step(jm, tx, JTCFG))
    w, sh = JTCFG.window_size, JTCFG.step
    xy, jcond = jnp.asarray(x)[..., :2], jnp.asarray(cond)
    slice_ = jax.lax.dynamic_slice_in_dim

    @jax.jit
    def jax_grads(p, start):
        def loss_fn(p):
            pred = jm.apply({"params": p}, slice_(xy, start, w, 2), slice_(jcond, 2 * start, 2 * (w + sh), 1))
            return jtrainer.traj_losses(pred, slice_(xy, start + sh, w, 2))[0]
        return jax.grad(loss_fn)(p)

    key = jax.device_put(jax.random.key(3), replicated(mesh))
    xs, cs = shard_batch((jnp.asarray(x), jcond), mesh)
    grads, metrics = [], []
    for start in p["starts"]:
        grads.append(traj_params_to_state_dict(jax.tree.map(np.asarray, jax_grads(jstate.params, start)),
                                               JTCFG.trans_layer))
        jstate, m = jstep(jstate, xs, cs, key)
        metrics.append({k: float(v) for k, v in m.items()})
    final = traj_params_to_state_dict(jax.tree.map(np.asarray, jstate.params), JTCFG.trans_layer)
    return grads, metrics, final, int(jstate.step)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    train_payload, traj_payload = _train_payload(), _traj_payload()
    rng = np.random.default_rng(3)
    dropout_payload = {"x": (rng.normal(size=(BS, 2, 12, 151)) * 0.3).astype(np.float32),
                       "cond": rng.normal(size=(BS, 25, 16)).astype(np.float32)}
    root = str(tmp_path_factory.mktemp("cli"))
    argv = ["--mode", "train", "--dp", "2", "--synthetic", "--synthetic_size", "8", "--device", "cpu",
            "--window_size", "16", "--required_dancer_num", "2", "--project", f"{root}/runs", "--exp_name", "t",
            "--render_dir", f"{root}/renders", "--no_render", "--epochs", "1", "--save_interval", "1",
            "--batch_size", "4"]
    payload = {"jax": train_payload, "dropout": dropout_payload, "traj": traj_payload,
               "cli": {"root": root, "argv": argv}}
    started = tp.start_ranks("train_cases", tmp_path_factory.mktemp("ranks"), payload)
    # the references, while the ranks run
    mesh = jax_make_mesh(dp=2, tp=1)
    refs = {"jax": _jax_train(train_payload, mesh), "traj": _jax_traj(traj_payload, mesh),
            "lone": tp.train_step_dropout(None, dropout_payload)}
    return {"ranks": tp.join_ranks(started), **refs}


def _by_name(tree):
    return params_to_state_dict(tree, JMCFG.num_layers, JMCFG.latent_dim)


def _assert_same_on_every_rank(ranks, pick):
    first = pick(ranks[0])
    for r in ranks[1:]:
        for name, t in pick(r).items():
            assert torch.equal(t, first[name]), name


def test_dp_train_step_matches_jax_dp_mesh(run):
    (s1, m1), (s2, m2) = run["jax"]
    for r, res in enumerate(run["ranks"]):
        got = res["jax"]
        assert got["step"] == 2
        for i, jm in enumerate((m1, m2)):
            for k in ("recon", "velocity", "fk", "foot", "total", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][i][k], jm[k], atol=3e-4, rtol=3e-4, err_msg=f"{r} {i} {k}")
        ref_p, ref_e = _by_name(s1.params), _by_name(s1.ema_params)
        for name, p in got["params1"].items():
            np.testing.assert_allclose(p.numpy(), ref_p[name], atol=3e-5, rtol=3e-4, err_msg=name)
            np.testing.assert_allclose(got["ema1"][name].numpy(), ref_e[name], atol=3e-5, rtol=3e-4, err_msg=name)
    _assert_same_on_every_rank(run["ranks"], lambda r: r["jax"]["params2"])


@pytest.mark.parametrize("step", [0, 1])
def test_dp_matches_one_process_at_dropout(run, step):
    lone = run["lone"]
    for r, res in enumerate(run["ranks"]):
        got = res["dropout"]
        for k, v in lone["metrics"][step].items():
            assert abs(got["metrics"][step][k] - v) <= 1e-5 * max(abs(v), 1e-12), (r, step, k)
        for name, ref in lone["grads"][step].items():
            scale = ref.abs().max().item()
            assert (got["grads"][step][name] - ref).abs().max().item() <= GRAD_TOL * scale, (r, step, name)
        if step == 0:
            for name, ref in lone["params"][0].items():
                assert (got["params"][0][name] - ref).abs().max().item() <= 1e-6, (r, name)
        else:
            for name, ref in lone["params"][1].items():
                off = ((got["params"][1][name] - ref).abs() > LR / 10).float().mean().item()
                assert off <= 0.05, (r, name, off)


def test_dp_ranks_hold_bit_identical_state(run):
    _assert_same_on_every_rank(run["ranks"], lambda r: r["dropout"]["params"][1])
    _assert_same_on_every_rank(run["ranks"], lambda r: r["dropout"]["ema"])
    _assert_same_on_every_rank(run["ranks"], lambda r: r["dropout"]["grads"][1])
    _assert_same_on_every_rank(run["ranks"], lambda r: r["traj"]["params"])
    _assert_same_on_every_rank(run["ranks"], lambda r: r["cli"]["params"])


def test_dp_traj_steps_match_jax_dp_mesh(run):
    grads, metrics, final, jstep = run["traj"]
    assert jstep == 2
    lr_now = JTCFG.lr * JTCFG.gamma  # the second update ran past the milestone
    for r, res in enumerate(run["ranks"]):
        got = res["traj"]
        assert got["last_epoch"] == 2
        for i in range(2):
            for k in ("recon", "dis_loss", "v_loss", "total"):
                np.testing.assert_allclose(got["metrics"][i][k], metrics[i][k], rtol=1e-5, err_msg=f"{r} {i} {k}")
            largest = max(np.abs(g).max() for g in grads[i].values())
            for name, ref in grads[i].items():
                g = got["grads"][i][name].numpy()
                if name.endswith("attn.key.bias"):  # zero in exact arithmetic: both are rounding
                    assert max(np.abs(ref).max(), np.abs(g).max()) <= 1e-6 * largest, name
                    continue
                np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=f"{r} {i} {name}")
        for name, p in got["params"].items():
            if name.endswith("attn.key.bias"):
                continue  # AdamW moves it by about lr x the sign of its rounding-level gradient
            off = np.mean(np.abs(p.numpy() - final[name]) > lr_now / 10)
            assert off <= 0.05, (name, off)


def test_cli_dp_train_writes_files_on_rank_0_only(run):
    rank0, rank1 = (r["cli"] for r in run["ranks"])
    assert rank0["dp"] == rank1["dp"] == 2 and rank0["step"] == rank1["step"] == 2
    final = [f for f in rank0["written"] if not f.endswith(".tmp")]
    assert [f for f in final if f.endswith(".pt")] == ["runs/t/checkpoints/ckpt_2.pt"]
    assert [f for f in final if f.endswith("metrics.jsonl")] == ["runs/t/metrics.jsonl"]
    assert rank1["written"] == []
