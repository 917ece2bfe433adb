"""The port's train-block ops (K3, K4, K5) against the JAX package's Pallas
train kernels, forward and backward.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own train-kernel tests run them; the port's CPU tensors take the
plain versions, differentiated by autograd. Same seeded numpy inputs and
the same cotangent into both (`jax.vjp` against `torch.autograd.grad`), in
f32 at small widths (b=2, L=16, Lm=6, d=64, 4 heads x 16, ff=64), at rate 0
and at rate 0.1 with the same seeds. The dropout masks are the same bits
(checked on their own below), so rate 0.1 compares exactly the same
function. Tolerance 1e-5 abs + 1e-5 rel: the two differ only in the order
of f32 sums (and PyTorch's erf against XLA's erf polynomial, within a few
f32 ulps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.models.rotary import rotary_freqs  # noqa: E402
from tcdiff_tpu.ops.fused_ca_block_train import fused_ca_block_train  # noqa: E402
from tcdiff_tpu.ops.fused_ff_block_train import fused_ff_tail_train  # noqa: E402
from tcdiff_tpu.ops.fused_sa_block_train import (  # noqa: E402
    _SALT_ATTN, _head_probs_sliced, _keep_mask, fused_sa_block_train, sa_train_tables,
)
from tcdiff_torch.ops.ca_block_train import ca_block_train  # noqa: E402
from tcdiff_torch.ops.ff_block_train import ff_tail_train  # noqa: E402
from tcdiff_torch.ops.sa_block_train import attention_train, sa_block_train  # noqa: E402
from tcdiff_torch.ops.train_common import keep_mask  # noqa: E402

B, L, LM, D, H, DK, FF = 2, 16, 6, 64, 4, 16, 64
HD = H * DK
TOL = dict(atol=1e-5, rtol=1e-5)
SEEDS = np.array([0x12345678, 0xDEADBEEF], dtype=np.uint32)  # one above 2^31


@pytest.mark.parametrize("salt,rows,cols,row0,rate", [
    (0x100, 16, 16, 0, 0.1), (0x103, 16, 6, 0, 0.1), (0x200, 16, 64, 0, 0.1),
    (0x400, 8, 64, 8, 0.5), (0x500, 450, 512, 0, 0.1), (0x300, 4, 4, 2**20, 0.9),
])
def test_keep_mask_is_bit_equal_to_jax(salt, rows, cols, row0, rate):
    seeds = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9], dtype=np.uint32)
    ours = keep_mask(torch.from_numpy(seeds.astype(np.int64)), salt, rows, cols, rate, row0).numpy()
    for i, s in enumerate(seeds):
        ref = np.asarray(_keep_mask(jnp.uint32(s), salt, (rows, cols), rate, row0))
        np.testing.assert_array_equal(ours[i], ref)
    assert 0 < ours.mean() < 1


def test_keep_mask_per_head_salts_match_one_salt_each():
    seeds = torch.from_numpy(SEEDS.astype(np.int64))
    per_head = keep_mask(seeds, 0x100 + torch.arange(H), L, LM, 0.1)
    for h in range(H):
        assert torch.equal(per_head[:, h], keep_mask(seeds, 0x100 + h, L, LM, 0.1))


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ln(rng):
    return 1.0 + _rand(rng, D, scale=0.1), _rand(rng, D, scale=0.1)


def _compare(jax_fn, torch_fn, arrays, transposed, cot):
    """Value and the vjp of every differentiable input. `transposed` names
    the weights whose JAX layout is (in, out)."""
    jarrs = [jnp.asarray(a.T if i in transposed else a) for i, a in enumerate(arrays)]
    out, vjp = jax.vjp(jax_fn, *jarrs)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = torch_fn(*targs)
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg.T if i in transposed else jg, **TOL,
                                   err_msg=f"gradient of input {i}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sa_block_train_matches_jax_kernel(rate):
    rng = np.random.default_rng(0)
    x = _rand(rng, B, L, D)
    s1, b1 = _ln(rng)
    s2, b2 = _ln(rng)
    wq, wk, wv = (_rand(rng, HD, D, scale=D**-0.5) for _ in range(3))
    wfc = _rand(rng, D, HD, scale=HD**-0.5)
    fs, fb = _rand(rng, B, D, scale=0.1), _rand(rng, B, D, scale=0.1)
    angles = rotary_freqs(L, D)
    cos, ssin = sa_train_tables(jnp.zeros((), jnp.float32), jnp.asarray(angles), D)
    seeds_j, seeds_t = jnp.asarray(SEEDS), torch.from_numpy(SEEDS.astype(np.int64))

    def jfn(x, s1, b1, wq, wk, wv, wfc, s2, b2, fs, fb):
        return fused_sa_block_train(x, s1, b1, cos, ssin, wq, wk, wv, wfc, s2, b2, fs, fb,
                                    seeds_j, H, rate, 1e-5, 1e-6)

    def tfn(x, s1, b1, wq, wk, wv, wfc, s2, b2, fs, fb):
        return sa_block_train(x, s1, b1, torch.from_numpy(angles), wq, wk, wv, wfc, s2, b2, fs, fb,
                              seeds_t, nhead=H, rate=rate)

    _compare(jfn, tfn, [x, s1, b1, wq, wk, wv, wfc, s2, b2, fs, fb], {3, 4, 5, 6},
             _rand(rng, B, L, D))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ca_block_train_matches_jax_kernel(rate):
    rng = np.random.default_rng(1)
    x, mem = _rand(rng, B, L, D), _rand(rng, B, LM, D)
    s2, b2 = _ln(rng)
    ss, sb = _ln(rng)
    wq, wk, wv = (_rand(rng, HD, D, scale=D**-0.5) for _ in range(3))
    wfc = _rand(rng, D, HD, scale=HD**-0.5)
    fs, fb = _rand(rng, B, D, scale=0.1), _rand(rng, B, D, scale=0.1)
    ax, am = rotary_freqs(L, D), rotary_freqs(LM, D)
    cosx, ssinx = sa_train_tables(jnp.zeros((), jnp.float32), jnp.asarray(ax), D)
    cosm, ssinm = sa_train_tables(jnp.zeros((), jnp.float32), jnp.asarray(am), D)
    seeds_j, seeds_t = jnp.asarray(SEEDS), torch.from_numpy(SEEDS.astype(np.int64))

    def jfn(x, mem, s2, b2, wq, wk, wv, wfc, ss, sb, fs, fb):
        return fused_ca_block_train(x, mem, s2, b2, cosx, ssinx, cosm, ssinm, wq, wk, wv, wfc,
                                    ss, sb, fs, fb, seeds_j, H, rate, 1e-5, 1e-6)

    def tfn(x, mem, s2, b2, wq, wk, wv, wfc, ss, sb, fs, fb):
        return ca_block_train(x, mem, s2, b2, torch.from_numpy(ax), torch.from_numpy(am),
                              wq, wk, wv, wfc, ss, sb, fs, fb, seeds_t, nhead=H, rate=rate)

    _compare(jfn, tfn, [x, mem, s2, b2, wq, wk, wv, wfc, ss, sb, fs, fb], {4, 5, 6, 7},
             _rand(rng, B, L, D))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ff_tail_train_matches_jax_kernel(rate):
    rng = np.random.default_rng(2)
    x = _rand(rng, B, L, D)
    s3, b3 = _ln(rng)
    s4, b4 = _ln(rng)
    w1, w2, w3 = _rand(rng, FF, D, scale=D**-0.5), _rand(rng, D, FF, scale=FF**-0.5), _rand(rng, D, D, scale=D**-0.5)
    bb1, bb2, bb3 = _rand(rng, FF, scale=0.1), _rand(rng, D, scale=0.1), _rand(rng, D, scale=0.1)
    fs, fb = _rand(rng, B, D, scale=0.1), _rand(rng, B, D, scale=0.1)
    seeds_j, seeds_t = jnp.asarray(SEEDS), torch.from_numpy(SEEDS.astype(np.int64))

    def jfn(*a):
        return fused_ff_tail_train(*a, seeds_j, rate, 1e-5)

    def tfn(*a):
        return ff_tail_train(*a, seeds_t, rate=rate)

    _compare(jfn, tfn, [x, s3, b3, w1, bb1, w2, bb2, fs, fb, s4, b4, w3, bb3], {3, 5, 11},
             _rand(rng, B, L, D))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq, lk", [(L, L), (L, LM)])
def test_attention_train_matches_jax_heads(rate, lq, lk):
    """The train attention alone (what K3 and K4 run inside; CPU: its plain
    version) against the JAX package's per-head math of the Pallas
    attention kernels (`_head_probs_sliced`, then pd . v), value and vjp."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, B, lq, HD), _rand(rng, B, lk, HD), _rand(rng, B, lk, HD)
    seeds_t = torch.from_numpy(SEEDS.astype(np.int64))

    def jfn(q, k, v):
        outs = []
        for b in range(B):
            heads = []
            for i in range(H):
                sl = slice(i * DK, (i + 1) * DK)
                _, pd = _head_probs_sliced(q[b, :, sl], k[b, :, sl], DK**-0.5, jnp.asarray(SEEDS[b]),
                                           _SALT_ATTN + i, rate, jnp.float32)
                heads.append(jnp.dot(pd, v[b, :, sl], preferred_element_type=jnp.float32))
            outs.append(jnp.concatenate(heads, axis=-1))
        return jnp.stack(outs)

    _compare(jfn, lambda q, k, v: attention_train(q, k, v, seeds_t, nhead=H, rate=rate), [q, k, v], set(),
             _rand(rng, B, lq, HD))


def test_train_ops_refuse_a_device_that_is_neither_cpu_nor_cuda():
    """A tensor on another device never falls back to the plain version."""
    meta = lambda *s: torch.empty(s, device="meta")
    x, w, v, f, s = meta(B, L, D), meta(HD, D), meta(D), meta(B, D), meta(B)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sa_block_train(x, v, v, meta(L, D), w, w, w, meta(D, HD), v, v, f, f, s, nhead=H, rate=0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ca_block_train(x, meta(B, LM, D), v, v, meta(L, D), meta(LM, D), w, w, w, meta(D, HD), v, v, f, f, s,
                       nhead=H, rate=0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ff_tail_train(x, v, v, meta(FF, D), meta(FF), meta(D, FF), v, f, f, v, v, meta(D, D), v, s, rate=0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        attention_train(meta(B, L, HD), meta(B, LM, HD), meta(B, LM, HD), s, nhead=H, rate=0.1)
