"""Which kernel function each site of a decoder layer calls, and whether it
takes the FiLM rows, in every serving configuration.

The layer's kernel functions (`sa_block_fn`, `ff_tail_fn`, `ff_block_fn`,
`ca_block_fn`, `ca_kv_fn`, `layer_fn`, `ln_matmul_fn`) are swapped for
stubs that record the call and run the plain version, and one request step
runs: `encode_cond_cfg` + `guided` (CFG dedup at layer 0, the k/v hoisted
unless the cache is off), or the uncached forward. The expected calls
follow `tcdiff_tpu/models/dance_decoder.py:715-1062`: K6 where the k/v
are hoisted, no trj_dist is given and the layer is not the CFG-dedup one;
FiLM inside K1, K2b and K7 over the memory only with `fuse_film` and at
the doubled batch; K2 for the FF block and tail, or K2b and the tail (K9
with `ln_matmul`). Where the JAX package runs XLA's code, the port's
default runs K7 over the hoisted k/v (`ca_kv`, FiLM inside), and over the
memory with the cache off; the plain site stays with ca_block off, int8
and the per-op configuration.
"""

import pytest

torch = pytest.importorskip("torch")

from tcdiff_torch import DanceDecoderConfig, DiffusionConfig, ServingKernels  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.ops.plain import _PLAIN  # noqa: E402

CFG = DanceDecoderConfig(seq_len=8, latent_dim=32, ff_size=32, num_layers=3, num_heads=2,
                         cond_feature_dim=12, dancer_num=2, head_dim=16)
SITES = ("sa_block_fn", "ff_tail_fn", "ff_block_fn", "ca_block_fn", "ca_kv_fn", "layer_fn", "ln_matmul_fn")
FILM_ARG = {"sa_block_fn": 12, "ff_block_fn": 7, "ca_block_fn": 12, "ca_kv_fn": 12}  # position of the FiLM scale rows


@pytest.fixture(scope="module")
def model():
    m = DanceDecoder(CFG, device="cpu").init_random(torch.Generator().manual_seed(0)).eval()
    calls = []
    for i, layer in enumerate(m.layers):
        for site in SITES:
            def stub(*args, _site=site, _i=i, **kw):
                film = _site == "ff_tail_fn" or (_site in FILM_ARG and len(args) > FILM_ARG[_site]
                                                 and args[FILM_ARG[_site]] is not None)
                if _site == "layer_fn":
                    film = kw.get("include_ff", True)  # here: whether K6 ran the FF section
                calls.append((_i, _site[:-3], film))
                return _PLAIN[_site](*args, **kw)
            setattr(layer, site, stub)
    return m, calls


def _run(model, kernels, cached=True, trj_dist=False):
    m, calls = model
    m.kernels = kernels
    calls.clear()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, CFG.tokens, CFG.nfeats), generator=g)
    cond = torch.randn((1, 2 * CFG.seq_len + 1, CFG.cond_feature_dim), generator=g)
    t = torch.tensor([5])
    dist = torch.randint(0, 10, (1, CFG.tokens, CFG.tokens), generator=g) if trj_dist else None
    with torch.no_grad():
        if cached:
            d = GaussianDiffusion(m, DiffusionConfig(), device="cpu")
            d.guided(x, None, t, 2.0, dist, cond_cache=d.encode_cond_cfg(cond))
        else:
            m(x, cond, t, None, dist)
    return sorted(calls)


def _layers(first, rest):
    """The expected calls: `first` at layer 0, `rest` at every other."""
    return sorted([(0, *c) for c in first] + [(i, *c) for i in range(1, CFG.num_layers) for c in rest])


# (configuration, expected calls of one guided step): layer 0 is the
# CFG-dedup layer, whose block kernels never take FiLM rows; K7 over the
# hoisted k/v (ca_kv) takes them at every layer, layer 0 included (its x is
# at the doubled batch by then)
KV = ("ca_kv", True)
GUIDED = {
    "default": (ServingKernels(), [("sa_block", False), KV, ("ff_tail", True)], None),
    "default, fuse_film": (ServingKernels(fuse_film=True), [("sa_block", False), KV, ("ff_tail", True)],
                           [("sa_block", True), KV, ("ff_tail", True)]),
    "layer_fuse": (ServingKernels(layer_fuse=True), [("sa_block", False), KV, ("ff_tail", True)],
                   [("layer", True)]),
    "layer_fuse, FF by K2": (ServingKernels(layer_fuse=True, layer_fuse_ff=False),
                             [("sa_block", False), KV, ("ff_tail", True)], [("layer", False), ("ff_tail", True)]),
    "layer_fuse, fuse_film": (ServingKernels(layer_fuse=True, fuse_film=True),
                              [("sa_block", False), KV, ("ff_tail", True)], [("layer", True)]),
    "ff_tail off": (ServingKernels(ff_tail=False), [("sa_block", False), KV, ("ff_block", False)], None),
    "ff_tail off, fuse_film": (ServingKernels(ff_tail=False, fuse_film=True),
                               [("sa_block", False), KV, ("ff_block", False)],
                               [("sa_block", True), KV, ("ff_block", True)]),
    "ff_tail off, ln_matmul": (ServingKernels(ff_tail=False, ln_matmul=True),
                               [("sa_block", False), KV, ("ff_block", False), ("ln_matmul", False)], None),
    "ca_block, k/v cache off": (ServingKernels(ca_block=True, kv_cache=False),
                                [("sa_block", False), ("ca_block", False), ("ff_tail", True)], None),
    "ca_block, k/v cache off, fuse_film": (
        ServingKernels(ca_block=True, kv_cache=False, fuse_film=True),
        [("sa_block", False), ("ca_block", False), ("ff_tail", True)],
        [("sa_block", True), ("ca_block", True), ("ff_tail", True)]),
    "ca_block over the k/v cache": (ServingKernels(ca_block=True), [("sa_block", False), KV, ("ff_tail", True)],
                                    None),
    "layer_fuse, k/v cache off": (ServingKernels(layer_fuse=True, kv_cache=False),
                                  [("sa_block", False), ("ca_block", False), ("ff_tail", True)], None),
    # the plain cross-attention site: TCDIFF_PALLAS_XAB=0, int8 (every block
    # kernel off by default), the per-op configuration (K9 for the FF chain)
    "ca_block off": (ServingKernels(ca_block=False), [("sa_block", False), ("ff_tail", True)], None),
    "int8": (ServingKernels(int8=True), [], None),
    "per_op": (ServingKernels.per_op(), [("ln_matmul", False), ("ln_matmul", False)], None),
}


@pytest.mark.parametrize("name", list(GUIDED))
def test_guided_step_routing(model, name):
    kernels, first, rest = GUIDED[name]
    assert _run(model, kernels) == _layers(first, first if rest is None else rest)


def test_layer_fuse_keeps_the_per_block_path_with_a_trj_dist(model):
    want = [("sa_block", False), KV, ("ff_tail", True)]
    assert _run(model, ServingKernels(layer_fuse=True), trj_dist=True) == _layers(want, want)


@pytest.mark.parametrize("fuse_film", [False, True])
def test_uncached_forward_routing(model, fuse_film):
    """No cond cache and no CFG dedup: K7 at every layer (FiLM inside with
    fuse_film), K6 nowhere."""
    calls = _run(model, ServingKernels(ca_block=True, layer_fuse=True, fuse_film=fuse_film), cached=False)
    want = [("sa_block", fuse_film), ("ca_block", fuse_film), ("ff_tail", True)]
    assert calls == _layers(want, want)
