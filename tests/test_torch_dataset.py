"""The port's AIOZ-GDance dataset against the JAX package's, on the CPU.

`_process_batch` (Y-up -> Z-up, SMPL FK, foot contacts, 6D packing into 151
channels) and the per-sample normalization on the same raw (pos, q); then
`AIOZDataset` on a raw tree made by the port's `create_dataset`, against
`tcdiff_tpu`'s `AIOZDataset` on the same tree; the npz cache across the
two packages; the synthetic draws.

Tolerances:
  * the packed, unnormalized channels at 1e-5 absolute (FK through 24
    joints in f32);
  * the contacts (a threshold, velocity < 0.01) equal, except where the
    JAX package's velocity lies within 1e-5 of 0.01: a velocity that close
    to the threshold can land on either side of it in another order of f32
    sums. The count of such flips is printed;
  * normalized values relative to each sample's range: each sample is
    divided by its own min/max, so a difference is taken back to the
    unnormalized units (x range / 2) and held to 1e-5 there.
Chunked processing equals whole-batch processing bit for bit.
"""

import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.data import dataset as jds  # noqa: E402
from tcdiff_tpu.data import synthetic as jsyn  # noqa: E402
from tcdiff_tpu.geometry import rotations as jrot  # noqa: E402
from tcdiff_tpu.geometry import skeleton as jskel  # noqa: E402
from tcdiff_torch.config import FOOT_JOINTS  # noqa: E402
from tcdiff_torch.data import dataset as ds  # noqa: E402
from tcdiff_torch.data import synthetic as syn  # noqa: E402
from tcdiff_torch.data.create_dataset import create_dataset  # noqa: E402

from _torch_data import write_raw_tree  # noqa: E402

ATOL = 1e-5
BAND = 1e-5  # contacts may differ where the reference velocity is this close to the threshold


@jax.jit
def _jax_feet(pos, q):
    root = jrot.quaternion_to_axis_angle(jrot.quat_multiply(jnp.asarray(jds._YUP_TO_ZUP_QUAT),
                                                            jrot.axis_angle_to_quaternion(q[..., 0, :])))
    q = q.at[..., 0, :].set(root)
    return jskel.smpl_fk(q, jds.rotate_points_x90(pos))[..., list(FOOT_JOINTS), :]


def _jax_foot_velocity(pos: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The JAX package's foot velocities (N, dn, S, 4) of `_process_one`."""
    feet = np.asarray(_jax_feet(jnp.asarray(pos), jnp.asarray(q)))
    vel = np.linalg.norm(feet[..., 1:, :, :] - feet[..., :-1, :, :], axis=-1)
    return np.concatenate([vel, np.zeros_like(vel[..., :1, :])], axis=-2)


def _flip_band(pos, q) -> np.ndarray:
    """(N, dn, S, 4) True where a contact may flip."""
    return np.abs(_jax_foot_velocity(pos, q) - 0.01) <= BAND


def _check_packed(out: np.ndarray, ref: np.ndarray, band: np.ndarray) -> int:
    """151 channels at ATOL, contacts equal off the band; returns the flips."""
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], atol=ATOL, rtol=0)
    differ = out[..., :4] != ref[..., :4]
    assert not (differ & ~band).any(), "contacts differ off the threshold band"
    return int(differ.sum())


def _check_normalized(out, ref, half_range, flips) -> None:
    """(out - ref) x range / 2 within ATOL, by sample and channel, off the
    contact flips."""
    err = np.abs(out - ref) * half_range
    err[..., :4][flips] = 0.0
    assert err.max() <= ATOL, err.max()


def _raw(n=6, seed=0):
    pos, q = syn.synthetic_motion(n, 3, 150, seed=seed)
    return pos, q.reshape(n, 3, 150, 24, 3)


def test_process_batch_matches_jax():
    pos, q = _raw()
    ref = np.asarray(jds._process_batch(jnp.asarray(pos), jnp.asarray(q)))
    out = ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q)).numpy()
    assert out.shape == (6, 3, 150, 151)
    assert 0 < out[..., :4].mean() < 1, "the data should hold feet in and out of contact"
    flips = _check_packed(out, ref, _flip_band(pos, q))
    print(f"contact flips within {BAND} of the threshold: {flips}")


def test_per_sample_normalization_matches_jax():
    pos, q = _raw(seed=3)
    packed = ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q))
    jpacked = jds._process_batch(jnp.asarray(pos), jnp.asarray(q))
    out, norm = ds._per_sample_normalize(packed)
    ref, jnorm = jds._per_sample_normalize(jpacked)
    flips = packed.numpy()[..., :4] != np.asarray(jpacked)[..., :4]
    p = packed.numpy().reshape(6, -1, 151)
    half_range = ((p.max(1) - p.min(1)) / 2)[:, None, None, :]
    _check_normalized(out.numpy(), np.asarray(ref), half_range, flips)
    # the dataset's normalizer is the LAST sample's own fit
    last = ds.Normalizer.fit(packed[-1], device="cpu")
    assert torch.equal(norm.scale, last.scale) and torch.equal(norm.offset, last.offset)
    # its stats against JAX's, in the data's units: min = -(offset + 1) / scale, range = 2 / scale
    for mine, theirs in (((-(norm.offset + 1) / norm.scale).numpy(),
                          np.asarray(-(jnorm.offset + 1) / jnorm.scale)),
                         ((2 / norm.scale).numpy(), np.asarray(2 / jnorm.scale))):
        keep = np.ones(151, bool)
        keep[:4] = ~flips[-1].reshape(-1, 4).any(0)  # a flipped contact changes its channel's range
        np.testing.assert_allclose(mine[keep], theirs[keep], atol=ATOL, rtol=0)


def test_chunked_processing_equals_whole():
    pos, q = _raw(n=7, seed=5)
    whole = ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q))
    for chunk in (1, 3):
        assert torch.equal(ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q), chunk=chunk), whole)


def test_synthetic_draws_match_jax():
    for a, b in zip(syn.synthetic_motion(3, 2, 40, seed=4), jsyn.synthetic_motion(3, 2, 40, seed=4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(syn.synthetic_music(2, 81, seed=6), jsyn.synthetic_music(2, 81, seed=6))
    poses, music, norm = syn.synthetic_dataset(3, 2, 40, seed=1, device="cpu")
    jposes, jmusic, _ = jsyn.synthetic_dataset(3, 2, 40, seed=1)
    np.testing.assert_array_equal(music, jmusic)
    assert poses.shape == (3, 2, 40, 151) and norm.scale.shape == (151,)
    pos, q = syn.synthetic_motion(3, 2, 40, seed=1)
    packed = ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q.reshape(3, 2, 40, 24, 3))).numpy()
    flips = packed[..., :4] != np.asarray(jds._process_batch(jnp.asarray(pos),
                                                             jnp.asarray(q.reshape(3, 2, 40, 24, 3))))[..., :4]
    p = packed.reshape(3, -1, 151)
    _check_normalized(poses, np.asarray(jposes), ((p.max(1) - p.min(1)) / 2)[:, None, None, :], flips)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("aioz_ds") / "AIOZ"
    write_raw_tree(root, ("seq_a", "seq_b"), ("seq_c",), dn=3, secs=5.5)
    create_dataset(types.SimpleNamespace(dataset_folder=str(root), root_path=str(root), stride=0.5, length=5.0,
                                         workers=1))
    return root


def _split_raw(root, split):
    """The split's slices as AIOZDataset reads them: (pos, q) stacked."""
    pos, q = [], []
    for p in sorted((root / split / "motions_sliced").glob("*.pkl")):
        with open(p, "rb") as f:
            d = pickle.load(f)
        pos.append(np.asarray(d["pos"], np.float32))
        q.append(np.asarray(d["q"], np.float32))
    pos, q = np.stack(pos), np.stack(q)
    return pos, q.reshape(q.shape[:3] + (24, 3))


def test_aioz_dataset_matches_jax(tree):
    train = ds.AIOZDataset(str(tree), train=True, device="cpu")
    test = ds.AIOZDataset(str(tree), train=False, normalizer=train.normalizer, device="cpu")
    jtrain = jds.AIOZDataset(str(tree), train=True)
    jtest = jds.AIOZDataset(str(tree), train=False, normalizer=jtrain.normalizer)
    assert len(train) == 4 and len(test) == 2
    assert train.feature_files == jtrain.feature_files and train.wav_files == jtrain.wav_files
    assert test.feature_files == jtest.feature_files

    pos, q = _split_raw(tree, "train")
    packed = ds._process_batch(torch.from_numpy(pos), torch.from_numpy(q)).numpy()
    flips = packed[..., :4] != np.asarray(jds._process_batch(jnp.asarray(pos), jnp.asarray(q)))[..., :4]
    assert not (flips & ~_flip_band(pos, q)).any()
    p = packed.reshape(len(packed), -1, 151)
    _check_normalized(train.poses, jtrain.poses, ((p.max(1) - p.min(1)) / 2)[:, None, None, :], flips)

    tpos, tq = _split_raw(tree, "test")
    tflips = _flip_band(tpos, tq)
    half_range = 1.0 / train.normalizer.scale.numpy()  # x scale is the test split's map
    err = np.abs(test.poses - jtest.poses) * half_range
    err[..., :4][tflips] = 0.0
    assert err.max() <= 2 * ATOL, err.max()  # the train stats' own error and the test data's

    batch = next(iter(train.batches(2, rng=np.random.default_rng(0))))
    jbatch = next(iter(jtrain.batches(2, rng=np.random.default_rng(0))))
    assert batch["filename"] == jbatch["filename"]
    np.testing.assert_array_equal(batch["cond"], jbatch["cond"])
    assert batch["x"].shape == (2, 3, 150, 151) and batch["cond"].shape == (2, 301, 438)


def test_cache_round_trips_across_the_packages(tree, tmp_path):
    train = ds.AIOZDataset(str(tree), train=True, device="cpu")
    jtrain = jds.AIOZDataset(str(tree), train=True)

    jtrain.save_cache(str(tmp_path / "jax.npz"))
    mine = ds.AIOZDataset.from_cache(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(mine.poses, jtrain.poses)
    assert mine.feature_files == jtrain.feature_files and mine.wav_files == jtrain.wav_files
    assert mine.train and mine.required_dancer_num == 3
    np.testing.assert_array_equal(mine.normalizer.scale.numpy(), np.asarray(jtrain.normalizer.scale))
    np.testing.assert_array_equal(mine.normalizer.offset.numpy(), np.asarray(jtrain.normalizer.offset))

    train.save_cache(str(tmp_path / "torch.npz"))
    theirs = jds.AIOZDataset.from_cache(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(theirs.poses, train.poses)
    assert theirs.feature_files == train.feature_files and theirs.wav_files == train.wav_files
    np.testing.assert_array_equal(np.asarray(theirs.normalizer.scale), train.normalizer.scale.numpy())
    again = ds.AIOZDataset.from_cache(str(tmp_path / "torch.npz"), device="cpu")
    np.testing.assert_array_equal(again.poses, train.poses)
    np.testing.assert_array_equal(again.normalizer.offset.numpy(), train.normalizer.offset.numpy())


def test_dataset_filters_and_errors(tree):
    ds_a = ds.AIOZDataset(str(tree), train=True, split_file=["seq_a"], device="cpu")
    assert len(ds_a) == 2 and all("seq_a_slice" in f for f in ds_a.feature_files)
    with pytest.raises(FileNotFoundError):
        ds.AIOZDataset(str(tree), train=True, required_dancer_num=2, device="cpu")
    with pytest.raises(ValueError):
        ds.AIOZDataset(str(tree), train=False, device="cpu")  # the test split needs a normalizer
    single = ds.AIOZDataset(str(tree), train=True, per_sample_normalization=False, device="cpu")
    assert np.abs(single.poses).max() <= 1.0
