"""The serving block kernels K2b, K7 and K6: the port's plain versions
against the JAX package's Pallas kernels.

`fused_ff_block` (K2b), `fused_ca_block` (K7) and `fused_layer` (K6) run
in Pallas interpret mode on the CPU, as the JAX package's own tests run
them; the port's CPU tensors take the plain versions (`ff_block`,
`ca_block`, `layer` dispatch there). Same seeded numpy inputs into both,
rounded alike to the compute dtype, small widths (b=2, L=24, Lm=10, d=64,
4 heads x 16, ff=48). Tolerances: f32 1e-5 abs/rel (the two differ only in
the order of f32 sums); bf16 2^-5 of the largest reference value, the
bound `chip_smoke.py` holds the CUDA kernels to (a product or a
probability rounded to bf16 on the other side of a tie moves an output by
an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.models.rotary import rotary_freqs  # noqa: E402
from tcdiff_tpu.ops.fused_ca_block import fused_ca_block  # noqa: E402
from tcdiff_tpu.ops.fused_ff_block import fused_ff_block  # noqa: E402
from tcdiff_tpu.ops.fused_layer import fused_layer  # noqa: E402
from tcdiff_torch.ops.ca_block import ca_block  # noqa: E402
from tcdiff_torch.ops.ff_block import ff_block  # noqa: E402
from tcdiff_torch.ops.layer import layer  # noqa: E402

B, L, LM, D, H, DK, FF = 2, 24, 10, 64, 4, 16, 48
HD = H * DK
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


class _Inputs:
    """Seeded inputs as JAX arrays (`j`) and torch tensors (`t`), the
    compute-dtype ones rounded alike; weights are stored (in, out) as the
    JAX kernels take them (the port takes their transposes)."""

    def __init__(self, seed, dtype, compute, vectors):
        rng = np.random.default_rng(seed)
        jd, td = DTYPES[dtype]
        self.j, self.t = {}, {}
        for name, shape in compute.items():
            scale = shape[0] ** -0.5 if name.startswith("w") else 1.0
            a = (rng.normal(size=shape) * scale).astype(np.float32)
            self.j[name], self.t[name] = jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)
        for name, (n, mean, std) in vectors.items():
            a = (mean + std * rng.normal(size=n)).astype(np.float32)
            self.j[name], self.t[name] = jnp.asarray(a), torch.from_numpy(a)

    def jax(self, *names):
        return [None if n is None else self.j[n] for n in names]

    def torch(self, *names):
        return [None if n is None else (self.t[n].T if n.startswith("w") else self.t[n]) for n in names]


def _ln(*names, d=D):
    """LayerNorm affines (d,): scales near 1, shifts near 0."""
    return {n: (d, 1.0 if n[0] == "s" else 0.0, 0.1) for n in names}


def _check(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2.0**-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [False, True])
def test_ff_block_matches_jax(dtype, film):
    a = _Inputs(0, dtype, dict(x=(B, L, D), w1=(D, FF), w2=(FF, D), fs=(B, D), fb=(B, D)),
                dict(_ln("s3", "b3"), bb1=(FF, 0.0, 0.1), bb2=(D, 0.0, 0.1)))
    names = ("x", "s3", "b3", "w1", "bb1", "w2", "bb2") + (("fs", "fb") if film else (None, None))
    ref = fused_ff_block(*a.jax(*names))
    _check(ff_block(*a.torch(*names)), ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [False, True])
def test_ca_block_matches_jax(dtype, film):
    a = _Inputs(1, dtype, dict(x=(B, L, D), mem=(B, LM, D), mrot=(B, LM, D), wq=(D, HD), wk=(D, HD),
                               wv=(D, HD), wfc=(HD, D), fs=(B, D), fb=(B, D)),
                _ln("s1", "b1", "s2", "b2"))
    angles = rotary_freqs(L, D)
    names = (("x", "s1", "b1"), ("mem", "mrot", "wq", "wk", "wv", "wfc", "s2", "b2")
             + (("fs", "fb") if film else (None, None)))
    ref = fused_ca_block(*a.jax(*names[0]), jnp.asarray(angles), *a.jax(*names[1]), nhead=H)
    out = ca_block(*a.torch(*names[0]), torch.from_numpy(angles), *a.torch(*names[1]), nhead=H)
    _check(out, ref, dtype)


# (include_ff, dtype, L, d): the base shape under its original ids, then a
# length that no tile of the CUDA kernels divides (L = 37) and the widths
# whose bf16 LayerNorm folds run in clusters of 1 and 2 blocks on the card
# (d = 128, 256)
_LAYER_CASES = [pytest.param(ff, dt, L, D, id=f"{ff}-{dt}") for ff in (False, True) for dt in DTYPES] + [
    pytest.param(ff, dt, length, d, id=f"{ff}-{dt}-L{length}-d{d}")
    for length, d in ((37, D), (L, 128), (L, 256)) for ff in (False, True) for dt in DTYPES]


@pytest.mark.parametrize("include_ff, dtype, length, d", _LAYER_CASES)
def test_layer_matches_jax(dtype, include_ff, length, d):
    a = _Inputs(2, dtype, dict(x=(B, length, d), wq=(d, HD), wk=(d, HD), wv=(d, HD), wfc=(HD, d),
                               wcq=(d, HD), wcfc=(HD, d), kcat=(B, LM, HD), vcat=(B, LM, HD),
                               w1=(d, FF), w2=(FF, d), w3=(d, d), f1s=(B, d), f1b=(B, d),
                               f2s=(B, d), f2b=(B, d), f3s=(B, d), f3b=(B, d)),
                dict(_ln("s1", "b1", "ss2", "sb2", "n2s", "n2b", "cs2", "cb2", "s3", "b3", "s4", "b4", d=d),
                     bb1=(FF, 0.0, 0.1), bb2=(d, 0.0, 0.1), bb3=(d, 0.0, 0.1)))
    angles = rotary_freqs(length, d)
    head = ("s1", "b1", "wq", "wk", "wv", "wfc", "ss2", "sb2", "f1s", "f1b",
            "n2s", "n2b", "wcq", "wcfc", "cs2", "cb2", "kcat", "vcat", "f2s", "f2b")
    ff = ("s3", "b3", "w1", "bb1", "w2", "bb2", "f3s", "f3b", "s4", "b4", "w3", "bb3") if include_ff else ()
    ref = fused_layer(a.j["x"], jnp.asarray(angles), *a.jax(*head, *ff), nhead=H, include_ff=include_ff)
    out = layer(a.t["x"], torch.from_numpy(angles), *a.torch(*head, *ff), nhead=H, include_ff=include_ff)
    _check(out, ref, dtype)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        ff_block(x, *([x] * 6))
    with pytest.raises(ValueError):
        ca_block(x, *([x] * 11), nhead=2)
    with pytest.raises(ValueError):
        layer(x, *([x] * 21), nhead=2, include_ff=False)
