"""TCDIFF_LN_BF16 in the port (`DanceDecoder.ln_bf16`): the LayerNorm sites
outside the kernels keep their statistics in the compute dtype, as the
JAX package's flax LayerNorms with force_float32_reductions=False.

  * one site: `_ln` against flax 0.12's nn.LayerNorm(dtype=bf16,
    force_float32_reductions=False) on a bf16 input, within one bf16 ulp
    of the output (the same rounding order; XLA's and PyTorch's f32 sums
    may differ in their last bit before the bf16 rounding);
  * a no-op in f32: the forward and the train forward with the flag equal
    those without, bit for bit;
  * the bf16 model (tests/_torch_parity.py's config, kernels off so that
    every LayerNorm site is a plain one) under TCDIFF_LN_BF16=1 against
    the JAX model under the same flag: the uncached and the guided
    forward within 2^-5 of the largest output (bf16 rounding through 2
    layers, the rule of the bf16 block tests);
  * `TCDiff` reads the flag from the environment.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

from _torch_parity import CFG, inputs, load_models  # noqa: E402
from _torch_tcdiff import cfgs, orch  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_torch import ServingKernels  # noqa: E402
from tcdiff_torch.config import DiffusionConfig  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder, _ln  # noqa: E402

PLAIN = ServingKernels(sa_block=False, ff_block=False, ca_block=False)
BF16_TOL = 2.0**-5


def test_one_site_matches_flax_bf16_statistics():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.normal(size=(3, 50, 64))).astype(np.float32)  # a mean far from 0, as a residual has
    scale, bias = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16, force_float32_reductions=False)
    ref = np.asarray(ln.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jx)
                     .astype(jnp.float32))
    mod = torch.nn.LayerNorm(64)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        f32_stats = _ln(mod, tx, 1e-5).float().numpy()
        mod.ln_bf16 = True
        out = _ln(mod, tx, 1e-5)
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out.float().numpy() - ref) <= ulp)
    assert np.mean(out.float().numpy() != ref) < 0.01
    assert np.abs(f32_stats - ref).max() > 0  # the flag changes the numbers


def test_flag_is_a_no_op_in_f32():
    _, params, _ = load_models()
    x, cond, t = inputs(2, 3)
    args = (torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
    outs = []
    for flag in (False, True):
        model = load_jax_params(DanceDecoder(CFG, device="cpu", ln_bf16=flag), params)
        assert all(m.ln_bf16 == flag for m in model.modules() if isinstance(m, torch.nn.LayerNorm))
        with torch.no_grad():
            outs.append((model(*args), model.forward_train(*args, generator=torch.Generator().manual_seed(1))))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_bf16_forward_matches_jax_under_the_flag(monkeypatch):
    monkeypatch.setenv("TCDIFF_LN_BF16", "1")
    _, params, _ = load_models()
    jmodel = JaxDecoder(CFG, dtype=jnp.bfloat16)
    tmodel = load_jax_params(DanceDecoder(CFG, dtype=torch.bfloat16, device="cpu", kernels=PLAIN, ln_bf16=True),
                             params).eval()
    x, cond, t = inputs(2, 1)
    keep = np.array([True, False])
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t),
                                           jnp.asarray(keep)))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), torch.from_numpy(keep))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=BF16_TOL * np.abs(ref).max())

    jd = JaxDiffusion(jmodel, JaxDiffusionConfig())
    guided = jax.jit(lambda p, x, t, c: jd.guided(p, x, None, t, 2.0, cond_cache=jd.encode_cond_cfg(p, c)))
    ref = np.asarray(guided(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))
    d = GaussianDiffusion(tmodel, DiffusionConfig(), device="cpu")
    with torch.no_grad():
        out = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                       cond_cache=d.encode_cond_cfg(torch.from_numpy(cond)))
        tmodel.ln_bf16 = False
        off = d.guided(torch.from_numpy(x), None, torch.from_numpy(t), 2.0,
                       cond_cache=d.encode_cond_cfg(torch.from_numpy(cond)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=BF16_TOL * np.abs(ref).max())
    assert not torch.equal(out, off)


def test_tcdiff_reads_the_flag(monkeypatch):
    _, pc = cfgs()
    monkeypatch.delenv("TCDIFF_LN_BF16", raising=False)
    assert not orch.TCDiff(pc, device="cpu").model.ln_bf16
    monkeypatch.setenv("TCDIFF_LN_BF16", "1")
    assert orch.TCDiff(pc, device="cpu").model.ln_bf16
