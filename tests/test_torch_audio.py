"""The port's host-side data path against the JAX package's: wav IO, the
438-d music features (bit for bit, on seeded signals and through a wav
file), the committed golden frames (as tests/test_dsp_golden.py holds the
JAX package's), and the min-max Normalizer (1e-6)."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.data import audio as jax_audio  # noqa: E402
from tcdiff_tpu.data import features as jax_features  # noqa: E402
from tcdiff_tpu.data.normalizer import Normalizer as JaxNormalizer  # noqa: E402
from tcdiff_torch.data import audio, features  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402

SR = features.SR
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "feats438_golden.npz"


def _clicks(seconds: float, seed: int) -> np.ndarray:
    """Quiet noise with a loud burst every half second."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=int(seconds * SR)).astype(np.float32) * 1e-2
    for s in range(0, len(y), SR // 2):
        n = min(64, len(y) - s)
        y[s:s + n] += rng.normal(size=n).astype(np.float32) * 0.5
    return y


def _chord(seconds: float) -> np.ndarray:
    """The golden clip of tests/test_dsp_golden.py: a C-major triad and
    120 BPM clicks."""
    t = np.arange(int(seconds * SR)) / SR
    y = sum(0.25 * np.sin(2 * np.pi * f * t + 0.1 * i) for i, f in enumerate([261.6256, 329.6276, 391.9954]))
    for s in range(0, len(y) - 64, SR // 2):
        y[s:s + 64] += 0.8 * np.hanning(64)
    return (y / np.abs(y).max() * 0.9).astype(np.float32)


def test_constants_match_jax():
    assert (features.FPS, features.HOP_LENGTH, features.SR) == (
        jax_features.FPS, jax_features.HOP_LENGTH, jax_features.SR)


@pytest.mark.parametrize("signal", ["clicks", "chord", "short"])
def test_features_match_jax_bit_for_bit(signal):
    y = {"clicks": lambda: _clicks(2.0, 0), "chord": lambda: _chord(2.5), "short": lambda: _clicks(0.3, 1)}[signal]()
    ours = features.extract_music_features(y)
    ref = jax_features.extract_music_features(y)
    assert ours.dtype == np.float32 and ours.shape[1] == 438 and ours.flags.c_contiguous
    np.testing.assert_array_equal(ours, ref)


def test_wav_processing_matches_jax(tmp_path):
    """Through a wav file at another rate (resampled on load) and back."""
    wav = str(tmp_path / "song.wav")
    audio.save_wav(wav, _clicks(1.5, 2)[::2], SR // 2)
    ours = features.wav_processing(wav, save_npy=True)
    np.testing.assert_array_equal(ours, jax_features.wav_processing(wav))
    np.testing.assert_array_equal(np.load(tmp_path / "song.npy"), ours)
    y, sr = audio.load_wav(wav)
    y_ref, sr_ref = jax_audio.load_wav(wav)
    assert sr == sr_ref == SR // 2
    np.testing.assert_array_equal(y, y_ref)


def test_golden_frames():
    """The committed regression fixture, as test_dsp_golden.py holds the
    JAX package's features to it."""
    feat = features.extract_music_features(_chord(2.5))
    golden = np.load(FIXTURE)
    np.testing.assert_array_equal(feat.shape, golden["shape"])
    np.testing.assert_allclose(feat[golden["frame_idx"]], golden["frames"], atol=1e-4, rtol=1e-4)


def _motion(seed: int) -> np.ndarray:
    """(4, 20, 151) with channel-wise scales and offsets; channel 7 is
    constant and channel 9 varies under 10 float eps (both get range 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 20, 151)) * rng.uniform(0.1, 5.0, 151) + rng.normal(size=151) * 3
    x[..., 7] = 2.5
    x[..., 9] = 1.0 + rng.integers(0, 2, size=(4, 20)) * 1e-7
    return x.astype(np.float32)


def test_normalizer_matches_jax():
    data = _motion(0)
    ours, ref = Normalizer.fit(data, device="cpu"), JaxNormalizer.fit(jnp.asarray(data))
    tol = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ours.scale.numpy(), np.asarray(ref.scale), **tol)
    np.testing.assert_allclose(ours.offset.numpy(), np.asarray(ref.offset), **tol)
    # the near-constant channel rule: the range taken as 1, so the scale is (hi - lo) / 1
    assert ours.scale[7].item() == ours.scale[9].item() == 2.0

    x = _motion(1)  # other data: some values fall outside [-1, 1] after the transform
    norm = ours.normalize(torch.from_numpy(x))
    np.testing.assert_allclose(norm.numpy(), np.asarray(ref.normalize(jnp.asarray(x))), **tol)
    assert norm.abs().max().item() <= 1.0
    back = ours.unnormalize(norm)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref.unnormalize(jnp.asarray(norm.numpy()))), **tol)
    inside = (norm.abs() < 1).numpy()
    np.testing.assert_allclose(back.numpy()[inside], x[inside], atol=1e-4, rtol=1e-5)  # the round trip

    # fewer channels: the TRAILING 147 stats, as the reference unnormalizes the non-contact channels
    tail = norm[..., 4:]
    np.testing.assert_allclose(ours.unnormalize(tail).numpy(),
                               np.asarray(ref.unnormalize(jnp.asarray(tail.numpy()))), **tol)
    np.testing.assert_array_equal(ours.unnormalize(tail).numpy(), back[..., 4:].numpy())


def test_normalizer_identity_and_reference_state():
    ident = Normalizer.identity(5, device="cpu")
    x = torch.linspace(-2, 2, 10).reshape(2, 5)
    np.testing.assert_array_equal(ident.normalize(x).numpy(), np.asarray(JaxNormalizer.identity(5).normalize(
        jnp.asarray(x.numpy()))))
    ref = JaxNormalizer.fit(jnp.asarray(_motion(2)))
    state = ref.to_numpy()
    ours = Normalizer.from_torch_state(state["scale"], state["offset"], device="cpu")
    np.testing.assert_array_equal(ours.to_numpy()["scale"], state["scale"])
    np.testing.assert_array_equal(ours.to_numpy()["offset"], state["offset"])
