"""The whole-layer configuration (K6) against the JAX package under the
same flags: TCDIFF_LAYER_FUSE=1, with TCDIFF_LAYER_FUSE_FF=1 (the FF
section inside K6) and 0 (K2 finishes the layer), K1 and K2 on.

K6 runs only over the hoisted cross-attention k/v and without a
trj_dist, so only the sampler path reaches it: encode_cond_cfg + guided,
and ddim_sample (`model.apply` without a cond cache never does). Layer 0
under CFG dedup keeps K1, the cached cross-attention and K2. Set-up and
tolerance in tests/_torch_parity.py.
"""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_ddim_sample, check_guided, load_models, use_flags  # noqa: E402

from tcdiff_torch import ServingKernels  # noqa: E402


@pytest.fixture(scope="module")
def models():
    return load_models(final_scale=0.1)


def _flags(monkeypatch, ff_in_layer: bool) -> ServingKernels:
    kernels = use_flags(monkeypatch, {"TCDIFF_LAYER_FUSE": "1", "TCDIFF_LAYER_FUSE_FF": "1" if ff_in_layer else "0"})
    assert kernels == ServingKernels(layer_fuse=True, layer_fuse_ff=ff_in_layer)
    return kernels


@pytest.mark.parametrize("ff_in_layer", [True, False])
def test_guided_forward_matches_jax(models, monkeypatch, ff_in_layer):
    models[2].kernels = _flags(monkeypatch, ff_in_layer)
    check_guided(models)


@pytest.mark.parametrize("ff_in_layer", [True, False])
def test_ddim_sample_matches_jax(models, monkeypatch, ff_in_layer):
    models[2].kernels = _flags(monkeypatch, ff_in_layer)
    check_ddim_sample(models)
