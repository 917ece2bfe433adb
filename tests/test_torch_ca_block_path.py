"""The serving cross-attention block (K7) in its configuration against the
JAX package under the same flags: TCDIFF_PALLAS_XAB=1 with
TCDIFF_KV_CACHE=0 (the cache would shadow K7), TCDIFF_FUSE_FILM 0 and 1.
The uncached forward and the guided step of a request, both on the memory
path; set-up and tolerance in tests/_torch_parity.py.
"""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import check_guided, check_uncached_forward, load_models, use_flags  # noqa: E402

from tcdiff_torch import ServingKernels  # noqa: E402


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
