"""The serving cross-attention block (K7) in its configurations against the
JAX package under the same flags: over the memory, TCDIFF_PALLAS_XAB=1
with TCDIFF_KV_CACHE=0 and TCDIFF_FUSE_FILM 0 and 1 (the uncached forward
and the guided step of a request); over the hoisted k/v, the default
flags (the guided step and a 3-step ddim_sample, where the JAX package
runs XLA's code at the site). Set-up and tolerance in
tests/_torch_parity.py. And K7's plain version over the hoisted k/v
(`ca_kv_plain`: the music rows' and the time rows' k/v apart, the FiLM
residual inside) against the plain site's math (`SBIMSA.cross_q`,
`SBIMSA.attend`, `featurewise_affine`) on one layer, in f32 at the same
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import CFG, TOL, check_ddim_sample, check_guided, check_uncached_forward, load_models, use_flags  # noqa: E402,E501

from tcdiff_torch import ServingKernels  # noqa: E402
from tcdiff_torch.models.dance_decoder import FiLMTransformerDecoderLayer, featurewise_affine  # noqa: E402
from tcdiff_torch.models.rotary import angle_table  # noqa: E402
from tcdiff_torch.ops.ca_block import ca_kv_plain  # noqa: E402


@pytest.fixture(scope="module")
def models():
    return load_models()


def _flags(monkeypatch, fuse_film: bool) -> ServingKernels:
    kernels = use_flags(monkeypatch, {"TCDIFF_PALLAS_XAB": "1", "TCDIFF_KV_CACHE": "0",
                                      "TCDIFF_FUSE_FILM": "1" if fuse_film else "0"})
    assert kernels == ServingKernels(ca_block=True, kv_cache=False, fuse_film=fuse_film)
    return kernels


@pytest.mark.parametrize("fuse_film", [False, True])
def test_uncached_forward_matches_jax(models, monkeypatch, fuse_film):
    models[2].kernels = _flags(monkeypatch, fuse_film)
    check_uncached_forward(models)


@pytest.mark.parametrize("fuse_film", [False, True])
def test_guided_forward_matches_jax(models, monkeypatch, fuse_film):
    """Layer 0 is the CFG-dedup layer: K7 there takes no FiLM rows."""
    models[2].kernels = _flags(monkeypatch, fuse_film)
    check_guided(models)


def _default(monkeypatch) -> ServingKernels:
    kernels = use_flags(monkeypatch, {})
    assert kernels == ServingKernels() and kernels.ca_block and kernels.kv_cache
    return kernels


def test_guided_forward_over_the_cache_matches_jax(models, monkeypatch):
    """The default flags: K7 over the hoisted k/v at every layer, the
    CFG-dedup layer's included."""
    models[2].kernels = _default(monkeypatch)
    check_guided(models)


def test_ddim_sample_over_the_cache_matches_jax(monkeypatch):
    models = load_models(final_scale=0.1)  # x0 mostly inside the clamp (tests/test_torch_layer_path.py)
    models[2].kernels = _default(monkeypatch)
    check_ddim_sample(models)


@pytest.mark.parametrize("b, strided", [(1, False), (4, True)])
def test_ca_kv_plain_matches_the_plain_site(b, strided):
    """One layer's cross-attention over k/v from two sources (strided: the
    time rows a view of all layers' projections, as the hoist makes them)
    against the plain site over their concatenation, FiLM outside."""
    g = torch.Generator().manual_seed(30 + b)
    d, n = CFG.latent_dim, CFG.num_heads
    hd = n * CFG.head_dim
    layer = FiLMTransformerDecoderLayer(d, n, CFG.ff_size, CFG.head_dim).eval()
    with torch.no_grad():
        for p in layer.parameters():  # (d,) vectors (LayerNorm scales among them) near 1, the rest near 0
            p.copy_((p.dim() == 1 and p.shape[0] == d) + 0.2 * torch.randn(p.shape, generator=g))
    L, lm = CFG.tokens, CFG.seq_len
    x = torch.randn(b, L, d, generator=g)
    t = torch.randn(b, d, generator=g)
    k_mem, v_mem = (torch.randn(b, lm, hd, generator=g) for _ in range(2))
    if strided:  # rows 2 apart in a (b, 2, 3, hd) array
        k_time, v_time = (torch.randn(b, 2, 3, hd, generator=g)[:, :, 1] for _ in range(2))
    else:
        k_time, v_time = (torch.randn(b, 2, hd, generator=g) for _ in range(2))
    ca, angles = layer.multihead_attn, angle_table(L, d, x.device)
    fs, fb = layer.film2(t)
    plain = ServingKernels(ca_block=False)
    with torch.no_grad():
        q = ca.cross_q(x, layer.norm2, angles, plain, fused=False)
        k, v = torch.cat([k_mem, k_time], dim=1), torch.cat([v_mem, v_time], dim=1)
        ref = x + featurewise_affine(ca.attend(q, k, v, plain), (fs, fb))
        out = ca_kv_plain(x, layer.norm2.weight, layer.norm2.bias, angles, k_mem, v_mem, k_time, v_time,
                          ca.w_qs.weight, ca.fc.weight, ca.layer_norm.weight, ca.layer_norm.bias, fs, fb, nhead=n)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
