"""The port's DDIM sampler against the JAX one on injected noise, and the
rotary and schedule tables against the JAX package's, exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.diffusion.schedules import DiffusionBuffers as JaxBuffers  # noqa: E402
from tcdiff_tpu.diffusion.schedules import ddim_times as jax_ddim_times  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.models.rotary import apply_rotary as jax_apply_rotary  # noqa: E402
from tcdiff_tpu.models.rotary import rotary_freqs as jax_rotary_freqs  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.diffusion.schedules import DiffusionBuffers, ddim_times  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.models.rotary import apply_rotary, rotary_freqs  # noqa: E402

CFG = DanceDecoderConfig(
    seq_len=16, latent_dim=64, ff_size=64, num_layers=2, num_heads=4,
    cond_feature_dim=24, dancer_num=3, head_dim=16,
)


@pytest.mark.parametrize("seq,dim", [(16, 64), (450, 512)])
def test_rotary_table_and_rotation_match(seq, dim):
    np.testing.assert_array_equal(rotary_freqs(seq, dim), jax_rotary_freqs(seq, dim))
    x = np.random.default_rng(0).normal(size=(2, seq, dim)).astype(np.float32)
    ang = rotary_freqs(seq, dim)
    ref = np.asarray(jax_apply_rotary(jnp.asarray(x), jnp.asarray(ang)))
    out = apply_rotary(torch.from_numpy(x), torch.from_numpy(ang)).numpy()
    # f32 cos/sin of the same table: PyTorch's and XLA's differ by an ulp
    np.testing.assert_allclose(out, ref, atol=3e-6, rtol=0)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedule_tables_match_exactly(schedule):
    ours, ref = DiffusionBuffers.create(schedule, 1000), JaxBuffers.create(schedule, 1000)
    for name in ("betas", "alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    for steps in (4, 50):
        np.testing.assert_array_equal(ddim_times(1000, steps), jax_ddim_times(1000, steps))


def test_ddim_sample_matches_jax_on_injected_noise():
    b, steps = 2, 4
    shape = (b, CFG.tokens, CFG.nfeats)
    rng = np.random.default_rng(0)
    cond = rng.normal(size=(b, 2 * CFG.seq_len + 1, CFG.cond_feature_dim)).astype(np.float32)
    x_0 = (0.1 * rng.normal(size=(b, CFG.tokens, 3))).astype(np.float32)
    noise = {"init": rng.normal(size=shape).astype(np.float32),
             "steps": rng.normal(size=(steps,) + shape).astype(np.float32)}
    jmodel = JaxDecoder(CFG)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1,) + shape[1:]), jnp.asarray(cond[:1]),
                         jnp.zeros((1,), jnp.int32))["params"]
    dcfg = DiffusionConfig(sampling_timesteps=steps)
    ref = JaxDiffusion(jmodel, dcfg).ddim_sample(
        params, shape, jnp.asarray(cond), jax.random.key(1), jnp.asarray(x_0), noise
    )
    model = load_jax_params(DanceDecoder(CFG, device="cpu"), jax.tree.map(np.asarray, params)).eval()
    out = GaussianDiffusion(model, dcfg, device="cpu").ddim_sample(
        shape, torch.from_numpy(cond), x_0=torch.from_numpy(x_0), noise=noise
    )
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out[..., 4:6].numpy(), x_0[..., :2])
    # f32, the order of sums differs: 3e-5 abs/rel (4e-6 seen)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=3e-5)
