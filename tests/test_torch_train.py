"""The port's train path against the JAX package's, on the CPU in f32.

The model is `tests/test_train.py`'s small config (1 layer, d=64, 4 heads
x 64, seq 12 x 2 dancers, dropout 0), initialised in flax, perturbed so
that every leaf shows, and loaded into the port. At dropout 0 the JAX
package's default CPU train path (unfused flax) computes the same function
as the port's plain block versions, so the same seeded inputs, `t`, noise
and keep mask give the same loss terms and gradients. Gradients, Adan
moments and EMA are compared by state-dict name through the linear
flax -> state-dict map.

Tolerances, each from the order of f32 sums: 3e-5 abs/rel for the loss
terms and gradients with t < 64. XLA's f32 exp puts the timestep-embedding
frequencies 1 ulp from PyTorch's, and sin(t * f) multiplies that by t, so
the whole-step test, whose t the JAX step draws in [0, 1000), allows 3e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.optim import adan as jax_adan  # noqa: E402
from tcdiff_tpu.optim import ema_update as jax_ema_update  # noqa: E402
from tcdiff_tpu.train import create_train_state as jax_create_state  # noqa: E402
from tcdiff_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params, params_to_state_dict  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.optim.ema import ema_update  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402

CFG_KW = dict(nfeats=151, seq_len=12, latent_dim=64, ff_size=64, num_layers=1, num_heads=4,
              dropout=0.0, cond_feature_dim=16, dancer_num=2)
MCFG, JMCFG = DanceDecoderConfig(**CFG_KW), JaxDecoderConfig(**CFG_KW)
DCFG, JDCFG = DiffusionConfig(cond_drop_prob=0.25), JaxDiffusionConfig(cond_drop_prob=0.25)
TOL = dict(atol=3e-5, rtol=3e-5)
BS = 4


def _by_name(tree):
    """A flax-shaped tree (params, grads, moments) -> {state-dict name: numpy}."""
    return params_to_state_dict(jax.tree.map(np.asarray, tree), MCFG.num_layers, MCFG.latent_dim)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(BS, MCFG.dancer_num, MCFG.seq_len, 151)) * 0.3).astype(np.float32)
    # some contacts above the 0.95 gate, so that the foot term is not zero
    x[..., :4] = rng.uniform(0.5, 1.5, size=x[..., :4].shape).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * MCFG.seq_len + 1, 16)).astype(np.float32)
    jmodel = JaxDecoder(JMCFG)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, MCFG.tokens, 151)),
                         jnp.zeros((1, 2 * MCFG.seq_len + 1, 16)), jnp.zeros((1,), jnp.int32))["params"]
    prng = np.random.default_rng(9)
    params = jax.tree.map(lambda p: p + 0.05 * prng.normal(size=p.shape).astype(np.float32), params)
    return jmodel, params, x, cond


def _port(params):
    model = load_jax_params(DanceDecoder(MCFG, device="cpu"), jax.tree.map(np.asarray, params))
    return model, GaussianDiffusion(model, DCFG, device="cpu")


def test_p_losses_terms_and_gradients_match_jax(setup):
    jmodel, params, x, cond = setup
    rng = np.random.default_rng(1)
    t = rng.integers(0, 64, size=BS).astype(np.int32)
    noise = rng.normal(size=(BS, MCFG.seq_len, MCFG.dancer_num, 151)).astype(np.float32)
    keep = np.array([True, False, True, True])
    jd = JaxDiffusion(jmodel, JDCFG)

    def jloss(p):
        return jd.p_losses(p, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t), jax.random.key(3),
                           noise=jnp.asarray(noise), keep_mask=jnp.asarray(keep))

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model, diff = _port(params)
    total, parts = diff.p_losses(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t),
                                 noise=torch.from_numpy(noise), keep_mask=torch.from_numpy(keep))
    total.backward()
    for k in ("recon", "velocity", "fk", "foot"):
        assert float(jparts[k]) > 0, k
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), **TOL)
    ref = _by_name(jgrads)
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g, ref[name], atol=TOL["atol"] * scale, rtol=TOL["rtol"], err_msg=name)


def test_adan_three_steps_match_jax():
    rng = np.random.default_rng(2)
    shapes = {"a": (8, 5), "b": (5,), "c": (3, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    for g in grads:
        g["c"] = np.zeros(shapes["c"], np.float32)  # no gradient in the port: zeros in JAX
    tx = jax_adan(1e-2, weight_decay=0.02)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = Adan(list(tp.values()), lr=1e-2, weight_decay=0.02)
    for step, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = None if k == "c" else torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {step} {k}")
            st = opt.state[p]
            for name in ("m", "v", "n"):
                np.testing.assert_allclose(st[name].numpy(), np.asarray(getattr(jstate, name)[k]),
                                           atol=1e-6, rtol=1e-6, err_msg=f"step {step} {k} {name}")
    # the first step only shrinks by the decay
    first = Adan([torch.tensor(p0["a"])], lr=1e-2, weight_decay=0.02)
    first.param_groups[0]["params"][0].grad = torch.from_numpy(grads[0]["a"])
    first.step()
    np.testing.assert_allclose(first.param_groups[0]["params"][0].numpy(), p0["a"] / (1 + 0.02 * 1e-2),
                               rtol=1e-7)


def test_ema_matches_jax():
    rng = np.random.default_rng(3)
    e, p = rng.normal(size=(2, 7, 3)).astype(np.float32)
    ref = jax_ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.9)["w"]
    te = torch.from_numpy(e.copy())
    ema_update([te], [torch.from_numpy(p)], 0.9)
    np.testing.assert_allclose(te.numpy(), np.asarray(ref), atol=1e-7, rtol=1e-7)


def test_train_step_matches_jax_make_train_step(setup):
    """Two whole steps (loss, backward, Adan, EMA) of both packages from the
    same weights, the port fed the t, noise and keep mask JAX's step draws.
    The metrics of both steps are compared, and the parameters and EMA
    after the first. After the second, Adan's update (m + v) / sqrt(n)
    divides by |g2 + 0.92 (g2 - g1)|, which nearly cancels for a few
    elements, so the 1e-5 gradient differences of t >= 64 move those by
    up to 45 lr; `test_adan_three_steps_match_jax` holds that update on
    identical gradients."""
    jmodel, params, x, cond = setup
    jd = JaxDiffusion(jmodel, JDCFG)
    tx = jax_adan(1e-3, weight_decay=0.02)
    jstate = jax_create_state(params, tx)
    jstep = jax.jit(jax_make_train_step(jd, tx, ema_beta=0.9, ema_interval=1))
    model, diff = _port(params)
    opt = Adan(model.parameters(), lr=1e-3, weight_decay=0.02)
    state = create_train_state(model, opt)
    step = make_train_step(diff, opt, ema_beta=0.9, ema_interval=1, device="cpu")
    rng = jax.random.key(5)
    for i in range(2):
        # the draws of JAX's train step (train_step.py, gaussian.py::loss/p_losses)
        k_t, k_rest = jax.random.split(jax.random.fold_in(rng, i))
        t = jax.random.randint(k_t, (BS,), 0, JDCFG.n_timestep)
        k_noise, k_keep, _ = jax.random.split(k_rest, 3)
        noise = jax.random.normal(k_noise, (BS, MCFG.seq_len, MCFG.dancer_num, 151), jnp.float32)
        keep = jax.random.bernoulli(k_keep, 1.0 - JDCFG.cond_drop_prob, (BS,))
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(cond), rng)
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(cond),
                        t=torch.from_numpy(np.array(t)), noise=torch.from_numpy(np.array(noise)),
                        keep_mask=torch.from_numpy(np.array(keep)))
        for k in ("recon", "velocity", "fk", "foot", "total", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), atol=3e-4, rtol=3e-4, err_msg=f"{i} {k}")
        if i == 0:
            ref_p, ref_e = _by_name(jstate.params), _by_name(jstate.ema_params)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), ref_p[name], atol=3e-5, rtol=3e-4, err_msg=name)
                np.testing.assert_allclose(state.ema_params[name].numpy(), ref_e[name], atol=3e-5,
                                           rtol=3e-4, err_msg=name)
    assert state.step == int(jstate.step) == 2


def test_train_forward_dropout_draws_from_the_generator():
    cfg = DanceDecoderConfig(**{**CFG_KW, "dropout": 0.1})
    model = DanceDecoder(cfg, device="cpu").init_random(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, cfg.tokens, 151)).astype(np.float32))
    cond = torch.from_numpy(rng.normal(size=(2, 2 * cfg.seq_len + 1, 16)).astype(np.float32))
    t = torch.tensor([3, 500])
    run = lambda seed: model.forward_train(x, cond, t, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError):
        model.forward_train(x, cond, t)  # dropout > 0 and no generator


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu():
    """Without device="cpu" the model, the diffusion and the train step
    take the GPU: where there is none, they raise instead of running on
    the CPU."""
    if torch.cuda.is_available():
        model = DanceDecoder(MCFG)
        assert all(p.is_cuda for p in model.parameters())
        diff = GaussianDiffusion(model, DCFG)
        make_train_step(diff, Adan(model.parameters(), lr=1e-4))
        return
    with pytest.raises((AssertionError, RuntimeError)):
        DanceDecoder(MCFG)
    model = DanceDecoder(MCFG, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        GaussianDiffusion(model, DCFG)
    with pytest.raises((AssertionError, RuntimeError)):
        make_train_step(GaussianDiffusion(model, DCFG, device="cpu"), Adan(model.parameters(), lr=1e-4))
