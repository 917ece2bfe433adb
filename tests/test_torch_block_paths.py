"""The FF block without its tail (K2b) in its serving configuration, and
the default configuration with the FiLM residual in or out of K1, against
the JAX package under the same flags: TCDIFF_PALLAS_FFT=0 (with
TCDIFF_FUSE_FILM 0 and 1, and with TCDIFF_PALLAS_LNMM=1, the tail through
K9), the TPU default with TCDIFF_FUSE_FILM 0 and 1 (the port's default
runs K7 at the cross-attention site), and the default with
TCDIFF_PALLAS_XAB=0 (the plain site there). The uncached forward and the
guided step of a request; set-up and tolerance in tests/_torch_parity.py.
"""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import BASE, check_guided, check_uncached_forward, load_models, use_flags  # noqa: E402

from tcdiff_torch import ServingKernels  # noqa: E402

CASES = {
    "default": {},
    "default_film": {"TCDIFF_FUSE_FILM": "1"},
    "k2b": {"TCDIFF_PALLAS_FFT": "0"},
    "k2b_film": {"TCDIFF_PALLAS_FFT": "0", "TCDIFF_FUSE_FILM": "1"},
    "k2b_lnmm": {"TCDIFF_PALLAS_FFT": "0", "TCDIFF_PALLAS_LNMM": "1"},
    "ca_block_off": {"TCDIFF_PALLAS_XAB": "0"},  # the plain cross-attention site
}


@pytest.fixture(scope="module")
def models():
    return load_models()


def test_configurations_read_from_the_flags():
    assert ServingKernels.from_env(BASE) == ServingKernels()
    assert ServingKernels.from_env(dict(BASE, **CASES["default_film"])) == ServingKernels(fuse_film=True)
    assert ServingKernels.from_env(dict(BASE, **CASES["k2b_lnmm"])) == ServingKernels(ff_tail=False, ln_matmul=True)
    assert ServingKernels.from_env(dict(BASE, **CASES["ca_block_off"])) == ServingKernels(ca_block=False)


@pytest.mark.parametrize("case", list(CASES))
def test_uncached_forward_matches_jax(models, monkeypatch, case):
    models[2].kernels = use_flags(monkeypatch, CASES[case])
    check_uncached_forward(models)


@pytest.mark.parametrize("case", list(CASES))
def test_guided_forward_matches_jax(models, monkeypatch, case):
    """Layer 0 is the CFG-dedup layer, whose block kernels take no FiLM
    rows."""
    models[2].kernels = use_flags(monkeypatch, CASES[case])
    check_guided(models)
