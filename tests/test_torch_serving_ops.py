"""The per-op serving kernels' plain versions (K8-K11) against the JAX
package's Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own tests run them; the port's CPU tensors take the plain
versions. Same seeded numpy inputs into both, small widths (b=2, L=24,
Lk=10, d=64, 4 heads x 16, n=48). Tolerances: f32 1e-5 abs/rel (the two
differ only in the order of f32 sums); bf16 2^-5 of the largest reference
value, the bound `chip_smoke.py` holds the CUDA kernels to (the inputs are
rounded to bf16 alike on both sides; a product or a probability rounded
to bf16 on the other side of a tie moves an output by an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.models.rotary import rotary_freqs  # noqa: E402
from tcdiff_tpu.ops.fused_attention import fused_attention, fused_attention_batched  # noqa: E402
from tcdiff_tpu.ops.fused_layernorm import fused_layernorm  # noqa: E402
from tcdiff_tpu.ops.fused_ln_matmul import fused_ln_matmul  # noqa: E402
from tcdiff_tpu.ops.fused_ln_rotary_matmul import fused_ln_rotary_matmul  # noqa: E402
from tcdiff_torch.ops.attention import attention  # noqa: E402
from tcdiff_torch.ops.layernorm import layernorm  # noqa: E402
from tcdiff_torch.ops.ln_matmul import ln_matmul  # noqa: E402
from tcdiff_torch.ops.ln_rotary_matmul import ln_rotary_matmul  # noqa: E402

B, L, LK, D, H, DK, N = 2, 24, 10, 64, 4, 16, 48
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _ln_params(seed):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32), (0.1 * rng.normal(size=D)).astype(np.float32)


def _both(a, dtype):
    """A numpy f32 array as (JAX, torch) arrays of `dtype`, rounded alike."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0**-5 * max(1.0, np.abs(ref).max())


# (dtype, rows, d): the base shape under its original ids, then row counts
# that are not multiples of the CUDA kernel's 8 warps a block, at the
# widths of its templated bodies (64, 512) and of its general one (96)
_LN_CASES = [pytest.param(dt, B * L, D, id=dt) for dt in DTYPES] + [
    pytest.param(dt, rows, d, id=f"{dt}-rows{rows}-d{d}")
    for d in (64, 96, 512) for rows in (37, 75) for dt in DTYPES]


@pytest.mark.parametrize("dtype, rows, d", _LN_CASES)
def test_layernorm_matches_jax(dtype, rows, d):
    jx, tx = _both(_normal(0, rows, d, scale=2.0) + 0.5, dtype)
    rng = np.random.default_rng(1)
    s, b = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32), (0.1 * rng.normal(size=d)).astype(np.float32)
    ref = fused_layernorm(jx, jnp.asarray(s), jnp.asarray(b), eps=1e-6)
    _check(layernorm(tx, torch.from_numpy(s), torch.from_numpy(b), 1e-6), ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [N, D])
def test_ln_matmul_matches_jax(dtype, n):
    jx, tx = _both(_normal(2, B, L, D), dtype)
    jw, tw = _both(_normal(3, D, n, scale=D**-0.5), dtype)
    s, b = _ln_params(4)
    bias = _normal(5, n, scale=0.5)
    ref = fused_ln_matmul(jx, jnp.asarray(s), jnp.asarray(b), jw, jnp.asarray(bias), eps=1e-5)
    out = ln_matmul(tx, torch.from_numpy(s), torch.from_numpy(b), tw.T, torch.from_numpy(bias), 1e-5)
    _check(out, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d, n", [(128, 256), (256, 768), (64, 40), (64, 50)])
def test_ln_matmul_widths_match_jax(dtype, d, n):
    """K9 at widths besides (D, N), N = 50 one the card's wgmma body does
    not take, with a bias of ~8: in bf16 the product rounded before the
    bias is added (the TPU kernel's order) matches the JAX kernel's bits
    but for the rare product rounded the other way by the order of the f32
    sums, where the F.linear order T(acc + bias) differs in about 30% of
    the outputs."""
    from tcdiff_torch.ops._common import ln_f32, mm_f32

    jx, tx = _both(_normal(15, B, L, d), dtype)
    jw, tw = _both(_normal(16, d, n, scale=d**-0.5), dtype)
    rng = np.random.default_rng(17)
    s, b = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32), (0.1 * rng.normal(size=d)).astype(np.float32)
    bias = _normal(18, n, scale=8.0)
    ref = fused_ln_matmul(jx, jnp.asarray(s), jnp.asarray(b), jw, jnp.asarray(bias), eps=1e-5)
    ts, tb, tbias = torch.from_numpy(s), torch.from_numpy(b), torch.from_numpy(bias)
    out = ln_matmul(tx, ts, tb, tw.T, tbias, 1e-5)
    _check(out, ref, dtype)
    if dtype == "bfloat16":
        ref = np.asarray(ref.astype(jnp.float32))
        other = (mm_f32(ln_f32(tx, ts, tb, 1e-5).to(tx.dtype), tw.T) + tbias).to(tx.dtype)
        assert np.mean(out.float().numpy() != ref) <= 0.01
        assert np.mean(other.float().numpy() != ref) > 0.02


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rot_only", [False, True])
def test_ln_rotary_matmul_matches_jax(dtype, rot_only):
    jx, tx = _both(_normal(6, B, L, D), dtype)
    s, b = _ln_params(7)
    angles = rotary_freqs(L, D)
    jr, tr = _both(_normal(8, D, 2 * H * DK, scale=D**-0.5), dtype)
    jp, tp = _both(_normal(9, D, H * DK, scale=D**-0.5), dtype)
    args = (jnp.asarray(s), jnp.asarray(b), jnp.asarray(angles))
    targs = (torch.from_numpy(s), torch.from_numpy(b), torch.from_numpy(angles))
    if rot_only:
        ref = fused_ln_rotary_matmul(jx, *args, jp, None, eps=1e-5)
        _check(ln_rotary_matmul(tx, *targs, tp.T, None, 1e-5), ref, dtype)
        return
    ref_qk, ref_v = fused_ln_rotary_matmul(jx, *args, jr, jp, eps=1e-5)
    qk, v = ln_rotary_matmul(tx, *targs, tr.T, tp.T, 1e-5)
    _check(qk, ref_qk, dtype)
    _check(v, ref_v, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lk", [L, LK])  # self- and cross-attention shapes
@pytest.mark.parametrize("variant", ["per_head", "trpe", "all_heads"])
def test_attention_matches_jax(dtype, lk, variant):
    jq, tq = _both(_normal(10, B, H, L, DK), dtype)
    jk, tk = _both(_normal(11, B, H, lk, DK), dtype)
    jv, tv = _both(_normal(12, B, H, lk, DK), dtype)
    scale = 1.0 / np.sqrt(DK)
    if variant == "all_heads":
        ref = fused_attention_batched(jq, jk, jv, scale)
        out = attention(tq, tk, tv, scale)
    elif variant == "per_head":
        ref = fused_attention(jq, jk, jv, scale)
        out = attention(tq, tk, tv, scale)
    else:
        table = _normal(13, H, 10, DK)
        # buckets -1 and 10, 11 are out of range: they add nothing
        dist = np.random.default_rng(14).integers(-1, 12, size=(B, L, lk)).astype(np.int32)
        ref = fused_attention(jq, jk, jv, scale, jnp.asarray(table), jnp.asarray(dist))
        out = attention(tq, tk, tv, scale, torch.from_numpy(table), torch.from_numpy(dist))
    _check(out, ref, dtype)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    v = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        layernorm(x, v, v)
    with pytest.raises(ValueError):
        ln_matmul(x, v, v, torch.zeros(8, 8, device="meta"), v)
    with pytest.raises(ValueError):
        ln_rotary_matmul(x, v, v, torch.zeros(4, 8, device="meta"), torch.zeros(8, 8, device="meta"))
    with pytest.raises(ValueError):
        attention(x[None], x[None], x[None], 0.5)
