"""TRPE in training: `GaussianDiffusion.p_losses(..., trj_dist=...)` of the
port against the JAX package's, on the CPU in f32.

Under a trj_dist the JAX package's train path sends the self-attention
block to XLA (its train kernel has no TRPE bias) and keeps the cross-
attention and FF train kernels; the port runs the block as plain PyTorch
math and K4 and K5 (their plain versions on the CPU). The model is
test_torch_remat.py's at 1 layer (d=64, 4 heads x 16, seq 12 x 2
dancers, dropout 0), initialised in flax and perturbed; t < 64, noise and
keep mask are injected; trj_dist is drawn from a numpy seed over the 10
buckets. Tolerance 3e-5 abs/rel for the loss terms and gradients, the
TRPE table's among them (test_torch_train.py's).
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
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params, params_to_state_dict  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402

CFG_KW = dict(nfeats=151, seq_len=12, latent_dim=64, ff_size=64, num_layers=1, num_heads=4, head_dim=16,
              dropout=0.0, cond_feature_dim=16, dancer_num=2)
MCFG, JMCFG = DanceDecoderConfig(**CFG_KW), JaxDecoderConfig(**CFG_KW)
TOL = dict(atol=3e-5, rtol=3e-5)
BS = 4


def test_p_losses_with_trj_dist_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(BS, MCFG.dancer_num, MCFG.seq_len, 151)) * 0.3).astype(np.float32)
    x[..., :4] = rng.uniform(0.5, 1.5, size=x[..., :4].shape).astype(np.float32)
    cond = rng.normal(size=(BS, 2 * MCFG.seq_len + 1, 16)).astype(np.float32)
    t = rng.integers(0, 64, size=BS).astype(np.int32)
    noise = rng.normal(size=(BS, MCFG.seq_len, MCFG.dancer_num, 151)).astype(np.float32)
    keep = np.array([True, False, True, True])
    trj = rng.integers(0, MCFG.max_dancers, size=(BS, MCFG.tokens, MCFG.tokens)).astype(np.int32)
    jmodel = JaxDecoder(JMCFG)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, MCFG.tokens, 151)),
                                  jnp.zeros((1, 2 * MCFG.seq_len + 1, 16)), jnp.zeros((1,), jnp.int32))["params"]
    prng = np.random.default_rng(9)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * prng.normal(size=p.shape).astype(np.float32), params)
    jd = JaxDiffusion(jmodel, JaxDiffusionConfig())

    def jloss(p):
        return jd.p_losses(p, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t), jax.random.key(3),
                           trj_dist=jnp.asarray(trj), noise=jnp.asarray(noise), keep_mask=jnp.asarray(keep))

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    model = load_jax_params(DanceDecoder(MCFG, device="cpu"), params)
    layer = model.layers[0]
    calls = {"sa": 0, "ca": 0, "ff": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    layer.sa_train_fn = counted("sa", layer.sa_train_fn)
    layer.ca_train_fn = counted("ca", layer.ca_train_fn)
    layer.ff_train_fn = counted("ff", layer.ff_train_fn)
    diff = GaussianDiffusion(model, DiffusionConfig(), device="cpu")
    total, parts = diff.loss(torch.from_numpy(x), torch.from_numpy(cond), t=torch.from_numpy(t),
                             noise=torch.from_numpy(noise), keep_mask=torch.from_numpy(keep),
                             trj_dist=torch.from_numpy(trj))
    total.backward()
    assert calls == {"sa": 0, "ca": 1, "ff": 1}  # the block in plain math, K4 and K5 as ever
    for k in ("recon", "velocity", "fk", "foot"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), **TOL)
    ref = params_to_state_dict(jax.tree.map(np.asarray, jgrads), MCFG.num_layers, MCFG.latent_dim)
    assert np.abs(ref["embeddings_table.weight"]).max() > 0
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g, ref[name], atol=TOL["atol"] * scale, rtol=TOL["rtol"], err_msg=name)
