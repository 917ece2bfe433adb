"""The port's eval metrics (tcdiff_torch/eval) against the JAX package's,
on the CPU, and the closed-form pins of tests/test_metrics_golden.py and
tests/test_geometric_features.py held by the port.

The geometric features are threshold tests, so two implementations may
differ in a frame whose tested quantity lies within rounding of its
threshold: the boolean matrices are compared frame by frame, and a
disagreement is allowed only where the port's margin is within
`MARGIN_BAND` (1e-4 in the feature's units) of 0 (`flips_off_band`).
Everything else: the feature maps 1e-6 relative (f32), the functions on
the host bit for bit on the same inputs, the report 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.eval import geometric as jgeo  # noqa: E402
from tcdiff_tpu.eval import metrics as jmet  # noqa: E402
from tcdiff_torch.config import FOOT_JOINTS  # noqa: E402
from tcdiff_torch.eval import geometric as geo  # noqa: E402
from tcdiff_torch.eval import metrics as met  # noqa: E402
from test_geometric_features import _dance, _ref_features  # noqa: E402

N, DN, T = 4, 3, 40


def _group_joints(seed: int, n: int = N, energetic: float = 1.0) -> np.ndarray:
    """(n, DN, T, 24, 3) float32 articulated motion around the rest pose."""
    return np.stack([np.stack([_dance(seed * 100 + i * DN + d, t=T, energetic=energetic) for d in range(DN)])
                     for i in range(n)]).astype(np.float32)


def _music(seed: int, n: int = N) -> np.ndarray:
    """(n, 2T+1, 438) with a one-hot beat (channel 53) every ~16 frames."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 2 * T + 1, 438)).astype(np.float32)
    m[..., 53] = 0.0
    for i in range(n):
        m[i, rng.integers(0, 8) + np.arange(0, 2 * T - 8, 16), 53] = 1.0
    return m


# ------------------------------------------------------------ feature maps
def test_constants_match_jax():
    assert geo.FEATURE_SPECS == jgeo.FEATURE_SPECS and geo.NUM_GEOMETRIC_FEATURES == 32
    assert (geo.HL, geo.SW, geo.HW) == (jgeo.HL, jgeo.SW, jgeo.HW)
    np.testing.assert_array_equal(geo._REST, jgeo._REST)


def test_kinetic_features_match_jax():
    joints = _group_joints(1)
    ref = np.stack([np.asarray(jmet.kinetic_features(jnp.asarray(c))) for c in joints.reshape(-1, T, 24, 3)])
    out = met.kinetic_features(torch.from_numpy(joints))
    assert out.shape == (N, DN, 72)
    np.testing.assert_allclose(out.reshape(-1, 72).numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(met.extract_features(joints, "kinetic"), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_geometric_frames_match_jax_off_the_band(seed):
    """Frame by frame, over (N, DN) clips at once; the margins' sign is the
    boolean matrix exactly."""
    joints = _group_joints(seed, energetic=1.0 + 0.5 * seed)
    margins = geo.geometric_feature_margins(torch.from_numpy(joints))
    frames = geo.geometric_feature_frames(torch.from_numpy(joints))
    assert frames.shape == (N, DN, T - 1, 32) and frames.dtype == torch.bool
    assert torch.equal(frames, margins > 0)
    ref = np.stack([np.asarray(jgeo.geometric_feature_frames(jnp.asarray(c))) for c in joints.reshape(-1, T, 24, 3)])
    ref = ref.reshape(frames.shape)
    assert geo.flips_off_band(frames, ref, margins) == 0
    assert 0.05 < ref.mean() < 0.95  # the features fire and rest
    clip = geo.boolean_geometric_features(torch.from_numpy(joints))
    np.testing.assert_allclose(clip.numpy(), frames.float().mean(-2).numpy(), atol=0)


def test_flips_off_band_counts_only_disagreements_off_the_band():
    frames = torch.tensor([True, False, True, False])
    ref = torch.tensor([False, False, True, True])
    assert geo.flips_off_band(frames, ref, torch.tensor([1e-5, 1.0, 1.0, -1.0])) == 1
    assert geo.flips_off_band(frames, ref, torch.tensor([1.0, 1.0, 1.0, -1e-6])) == 1
    assert geo.flips_off_band(frames.numpy(), ref.numpy(), np.array([1e-5, 1.0, 1.0, 1e-5])) == 0


# ------------------------------------------- the pins of test_geometric_features.py
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorized_matches_per_frame_reference(seed):
    joints = _dance(seed)
    ref = _ref_features(joints)  # f64, one frame at a time
    x = torch.from_numpy(np.asarray(joints, np.float32))
    out = geo.geometric_feature_frames(x)
    assert out.shape == ref.shape == (joints.shape[0] - 1, 32)
    assert geo.flips_off_band(out, ref.astype(bool), geo.geometric_feature_margins(x)) == 0


def test_features_fire_and_discriminate():
    lively = np.stack([_dance(s, energetic=1.0) for s in range(16)])
    static = np.stack([_dance(100 + s, energetic=0.02) for s in range(16)])
    fg_l = met.extract_features(lively, "geometric")
    fg_s = met.extract_features(static, "geometric")
    assert fg_l.shape == (16, 32)
    assert (fg_l.mean(axis=0) > 0).sum() >= 8
    assert met.frechet_distance(fg_l, fg_s) > 10 * max(met.frechet_distance(fg_l[:8], fg_l[8:]), 1e-6)


def test_rotation_invariance_about_up_axis():
    joints = _dance(3)
    th = 1.1
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    a = geo.boolean_geometric_features(torch.from_numpy(joints.astype(np.float32)))
    b = geo.boolean_geometric_features(torch.from_numpy((joints @ rot.T).astype(np.float32)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------- the pins of test_metrics_golden.py
def test_fid_matches_1d_closed_form():
    rng = np.random.default_rng(0)
    a = rng.normal(2.0, 1.5, size=(4000, 1))
    b = rng.normal(-1.0, 0.5, size=(4000, 1))
    s1, s2 = np.cov(a, rowvar=False).item(), np.cov(b, rowvar=False).item()
    closed = (a.mean() - b.mean()) ** 2 + (np.sqrt(s1) - np.sqrt(s2)) ** 2
    np.testing.assert_allclose(met.frechet_distance(a, b), closed, rtol=1e-6)


def test_fid_matches_independent_eigh_implementation():
    from test_metrics_golden import _fid_eigh

    rng = np.random.default_rng(1)
    a = rng.normal(size=(500, 8)) @ rng.normal(size=(8, 8)) + rng.normal(size=8)
    b = rng.normal(size=(400, 8)) @ rng.normal(size=(8, 8))
    np.testing.assert_allclose(met.frechet_distance(a, b), _fid_eigh(a, b), rtol=1e-5)


def test_fid_invariances():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(300, 6))
    assert abs(met.frechet_distance(a, a.copy())) < 1e-6
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    b = rng.normal(size=(300, 6)) * 2 + 1
    np.testing.assert_allclose(met.frechet_distance(a @ q, b @ q), met.frechet_distance(a, b), rtol=1e-4, atol=1e-6)


def _speed_profile(speeds):
    steps = np.concatenate([[0.0], np.asarray(speeds)]) / 30.0
    joints = np.zeros((len(steps), 24, 3))
    joints[:, :, 0] = np.cumsum(steps)[:, None]
    return joints


def test_kinematic_beats_and_alignment_closed_form():
    speeds = np.linspace(1.0, 2.0, 60)
    for f in (10, 30, 50):
        speeds[f] = 0.1
    joints = _speed_profile(speeds)
    np.testing.assert_array_equal(met.kinematic_beats(torch.from_numpy(joints)), [10, 30, 50])
    np.testing.assert_allclose(met.beat_alignment_score(joints, np.array([10, 30, 50])), 1.0, atol=1e-9)
    np.testing.assert_allclose(met.beat_alignment_score(joints, np.array([12, 32, 52])), np.exp(-4.0 / 18.0),
                               atol=1e-9)


def test_foot_skating_exact_fraction():
    joints = np.zeros((41, 24, 3))
    joints[:, :, 2] = 1.0
    joints[:, FOOT_JOINTS, 2] = 0.0
    for t in range(10, 20):
        joints[t + 1:, FOOT_JOINTS, 0] += 0.01  # 0.3 units/s > 0.075
    got = met.foot_skating_ratio(torch.from_numpy(joints.astype(np.float32)))
    np.testing.assert_allclose(float(got), 10.0 / 40.0, atol=1e-7)


def test_collision_frequency_exact_fraction():
    roots = np.zeros((2, 50, 3))
    roots[1, :, 0] = 10.0
    roots[1, 20:30, 0] = 0.1
    np.testing.assert_allclose(float(met.collision_frequency(torch.from_numpy(roots))), 10.0 / 50.0, atol=1e-7)


def test_gmc_bounds():
    a = np.random.default_rng(3).normal(size=(1, 30, 24, 3)).cumsum(axis=1)
    np.testing.assert_allclose(met.group_motion_consistency(np.concatenate([a, a])), 1.0, atol=1e-6)
    b = np.zeros((2, 30, 24, 3))
    b[0, :, :, 0] = np.arange(30)[:, None]
    b[1, :, :, 1] = np.arange(30)[:, None]
    np.testing.assert_allclose(met.group_motion_consistency(b), 0.0, atol=1e-6)
    np.testing.assert_allclose(met.group_motion_consistency(a), 1.0)  # one dancer


# ------------------------------------------------------------- the functions
def test_host_functions_match_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    fa, fb = rng.normal(size=(12, 72)).astype(np.float32), rng.normal(size=(9, 72)).astype(np.float32)
    assert met.frechet_distance(fa, fb) == jmet.frechet_distance(fa, fb)
    small = rng.normal(size=(5, 32)).astype(np.float32)  # singular covariances: the eps ridge
    assert met.frechet_distance(small, small[::-1] + 0.1) == jmet.frechet_distance(small, small[::-1] + 0.1)
    assert met.diversity(fa) == jmet.diversity(fa) and met.diversity(fa[:1]) == jmet.diversity(fa[:1]) == 0.0
    joints = _group_joints(5)[0, 0]
    music = _music(6)[0]
    np.testing.assert_array_equal(met.kinematic_beats(joints), jmet.kinematic_beats(joints))
    beats = met.music_beats_from_features(music)
    np.testing.assert_array_equal(beats, jmet.music_beats_from_features(music))
    assert len(beats) >= 4
    assert met.beat_alignment_score(joints, beats) == jmet.beat_alignment_score(joints, beats)


def test_device_functions_match_jax():
    joints = _group_joints(7)
    roots = joints[..., 0, :]
    roots[:, 1, 10:20, :2] = roots[:, 0, 10:20, :2] + 0.1  # some collisions
    skate = met.foot_skating_ratio(torch.from_numpy(joints))
    coll = met.collision_frequency(torch.from_numpy(roots))
    assert skate.shape == coll.shape[:1] + (DN,) and coll.shape == (N,)
    for i in range(N):
        np.testing.assert_allclose(coll[i].item(), float(jmet.collision_frequency(jnp.asarray(roots[i]))), rtol=1e-6)
        np.testing.assert_allclose(met.group_motion_consistency(joints[i]),
                                   jmet.group_motion_consistency(joints[i]), rtol=1e-5)
        for d in range(DN):
            np.testing.assert_allclose(skate[i, d].item(), float(jmet.foot_skating_ratio(jnp.asarray(joints[i, d]))),
                                       rtol=1e-6)
    assert coll.max() > 0 and skate.max() > 0


@pytest.mark.parametrize("with_extras", [True, False])
def test_evaluate_matches_jax(with_extras):
    """The whole report on (N, DN, T) groups; the report's keys and values
    within 1e-5 relative, once no geometric feature flipped (asserted)."""
    gen, ref = _group_joints(8), _group_joints(9, energetic=0.7)
    music = list(_music(10)) if with_extras else None
    roots = gen[..., 0, :] if with_extras else None
    margins = geo.geometric_feature_margins(torch.from_numpy(gen))
    jframes = np.stack([np.asarray(jgeo.geometric_feature_frames(jnp.asarray(c)))
                        for c in gen.reshape(-1, T, 24, 3)]).reshape(margins.shape)
    assert torch.equal(margins > 0, torch.from_numpy(jframes))
    want = jmet.evaluate(gen, ref, music_feats=music, gen_roots=roots)
    got = met.evaluate(torch.from_numpy(gen), torch.from_numpy(ref), music_feats=music,
                       gen_roots=None if roots is None else torch.from_numpy(roots))
    assert set(got) == set(want) == ({"fid_k", "fid_g", "div_k", "div_g", "foot_skate", "gmc"}
                                     | ({"beat_align", "collision_freq"} if with_extras else set()))
    for k in want:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12, err_msg=k)
