"""`--remat` in the port: each decoder layer under torch.utils.checkpoint on
the train path, against the JAX package's `DanceDecoder(remat=True)`, on
the CPU in f32.

The model is test_torch_train.py's small config widened to 2 layers and
TRPE-sized heads (2 layers, d=64, 4 heads x 16, seq 12 x 2 dancers),
initialised in flax, perturbed so that every leaf shows and loaded into
the port. Tolerances:

  * against JAX (dropout 0, t < 64 injected with the noise and keep mask):
    3e-5 abs/rel for the loss terms and gradients (f32 sums in another
    order), as test_torch_train.py, whose depth of 1 layer this comparison
    keeps. At 2 layers the two packages' f32 roundings alone (with or
    without remat on either side) reach 4e-5 in a few of the final
    layer's gradients, and the foot-skate term's contact gate (`> 0.95`,
    a step in the model's own output) can fall on either side of a
    predicted contact within rounding of 0.95, which moves gradients by up
    to 6e-4; the remat of 2 layers is held by the bit-for-bit test;
  * remat against no remat in the port (dropout 0.1, one generator seed):
    bit for bit. Every draw of a layer is made before the layer runs, so
    the recomputed forward sees the same dropout; a redrawn seed would
    change the gradients;
  * the sampler: remat changes nothing in serving, so bit for bit against
    the port without remat and 3e-5 against the JAX package's remat
    sampler (which drops the k/v hoist and the CFG dedup: the same math).
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
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params, params_to_state_dict  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402

CFG_KW = dict(nfeats=151, seq_len=12, latent_dim=64, ff_size=64, num_layers=2, num_heads=4, head_dim=16,
              dropout=0.0, cond_feature_dim=16, dancer_num=2)
MCFG, JMCFG = DanceDecoderConfig(**CFG_KW), JaxDecoderConfig(**CFG_KW)
TOL = dict(atol=3e-5, rtol=3e-5)
BS = 4


ONE_LAYER = {**CFG_KW, "num_layers": 1}


def _by_name(tree, num_layers: int = MCFG.num_layers):
    return params_to_state_dict(jax.tree.map(np.asarray, tree), num_layers, MCFG.latent_dim)


def params_one_layer(params):
    """The 2-layer tree without its second decoder layer."""
    return {k: v for k, v in params.items() if k != "decoder_1"}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(BS, MCFG.dancer_num, MCFG.seq_len, 151)) * 0.3).astype(np.float32)
    x[..., :4] = rng.uniform(0.5, 1.5, size=x[..., :4].shape).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * MCFG.seq_len + 1, 16)).astype(np.float32)
    params = jax.jit(JaxDecoder(JMCFG).init)(jax.random.key(0), jnp.zeros((1, MCFG.tokens, 151)),
                                             jnp.zeros((1, 2 * MCFG.seq_len + 1, 16)),
                                             jnp.zeros((1,), jnp.int32))["params"]
    prng = np.random.default_rng(9)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * prng.normal(size=p.shape).astype(np.float32), params)
    return params, x, cond


def _injected(seed: int):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 64, size=BS).astype(np.int32)
    noise = rng.normal(size=(BS, MCFG.seq_len, MCFG.dancer_num, 151)).astype(np.float32)
    keep = rng.uniform(size=BS) < 0.75
    return t, noise, keep


def _grads(model) -> dict:
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()}


def test_remat_train_steps_match_jax_remat(setup):
    """Two train steps of the port with remat (loss, backward through the
    recomputed layers, Adan, EMA) against the JAX package's remat model's
    loss, gradients and Adan update on the same injected t, noise and keep
    mask."""
    params, x, cond = setup
    jd = JaxDiffusion(JaxDecoder(JaxDecoderConfig(**ONE_LAYER), remat=True), JaxDiffusionConfig())
    tx = jax_adan(1e-3, weight_decay=0.02)
    jparams, jopt = params, tx.init(params)
    params = params_one_layer(params)
    model = load_jax_params(DanceDecoder(DanceDecoderConfig(**ONE_LAYER), device="cpu", remat=True), params)
    opt = Adan(model.parameters(), lr=1e-3, weight_decay=0.02)
    state = create_train_state(model, opt)
    step = make_train_step(GaussianDiffusion(model, DiffusionConfig(), device="cpu"), opt, ema_beta=0.9,
                           device="cpu")
    def jloss(p, t, noise, keep):
        return jd.p_losses(p, jnp.asarray(x), jnp.asarray(cond), t, jax.random.key(0), noise=noise, keep_mask=keep)

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for i in range(2):
        t, noise, keep = _injected(10 + i)
        (jtotal, jparts), jgrads = jgrad(jparams, t, noise, keep)
        upd, jopt = jax.jit(tx.update)(jgrads, jopt, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(cond), t=torch.from_numpy(t),
                        noise=torch.from_numpy(noise), keep_mask=torch.from_numpy(keep))
        for k in ("recon", "velocity", "fk", "foot"):
            np.testing.assert_allclose(m[k].item(), float(jparts[k]), **TOL, err_msg=f"{i} {k}")
        np.testing.assert_allclose(m["total"].item(), float(jtotal), **TOL)
        ref = _by_name(jgrads, 1)
        for name, g in _grads(model).items():
            scale = max(1.0, float(np.abs(ref[name]).max()))
            np.testing.assert_allclose(g.numpy(), ref[name], atol=TOL["atol"] * scale, rtol=TOL["rtol"],
                                       err_msg=f"{i} {name}")
        if i == 0:
            ref_p = _by_name(jparams, 1)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), ref_p[name], **TOL, err_msg=name)


@pytest.mark.parametrize("trpe", [False, True])
def test_remat_gradients_equal_no_remat_bit_for_bit(setup, trpe):
    """At dropout 0.1 (K3-K5's seeds and, under TRPE, the plain
    self-attention's keep masks drawn before each layer) the loss and every
    gradient with remat equal those without, bit for bit."""
    params, x, cond = setup
    cfg = DanceDecoderConfig(**{**CFG_KW, "dropout": 0.1})
    t, noise, keep = _injected(20)
    trj = np.random.default_rng(21).integers(0, 10, size=(BS, cfg.tokens, cfg.tokens)) if trpe else None
    out = []
    for remat in (False, True):
        model = load_jax_params(DanceDecoder(cfg, device="cpu", remat=remat), params)
        diff = GaussianDiffusion(model, DiffusionConfig(), device="cpu")
        total, _ = diff.p_losses(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t),
                                 torch.Generator().manual_seed(5), noise=torch.from_numpy(noise),
                                 keep_mask=torch.from_numpy(keep),
                                 trj_dist=None if trj is None else torch.from_numpy(trj))
        total.backward()
        out.append((total.detach(), _grads(model)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    if trpe:  # the TRPE table is trained through the bias
        assert g0["embeddings_table.weight"].abs().sum() > 0


def test_remat_sampler_is_the_sampler_without_remat(setup):
    """A 3-step ddim_sample on injected noise: the port's with remat equals
    the port's without bit for bit, and both the JAX package's remat
    sampler's within 3e-5."""
    params, _, _ = setup
    b, steps = 2, 3
    shape = (b, MCFG.tokens, MCFG.nfeats)
    rng = np.random.default_rng(4)
    cond = rng.normal(size=(b, 2 * MCFG.seq_len + 1, 16)).astype(np.float32)
    x_0 = (0.1 * rng.normal(size=(b, MCFG.tokens, 3))).astype(np.float32)
    noise = {"init": rng.normal(size=shape).astype(np.float32),
             "steps": rng.normal(size=(steps,) + shape).astype(np.float32)}
    dcfg = DiffusionConfig(n_timestep=60, sampling_timesteps=steps)
    ref = JaxDiffusion(JaxDecoder(JMCFG, remat=True), JaxDiffusionConfig(n_timestep=60, sampling_timesteps=steps)
                       ).ddim_sample(params, shape, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0), noise)
    outs = []
    for remat in (False, True):
        model = load_jax_params(DanceDecoder(MCFG, device="cpu", remat=remat), params).eval()
        outs.append(GaussianDiffusion(model, dcfg, device="cpu").ddim_sample(
            shape, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(ref), **TOL)
