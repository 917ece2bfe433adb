"""The port's rotation conversions for post-processing and export against
the JAX package's, on the CPU in f32: `quat_slerp` (the shorter-arc flip,
antipodal pairs, the linear branch of near-identical pairs, and weights
per element), `matrix_to_axis_angle` near pi, `ax_from_6v`, `quat_to_6v`
and `quat_from_6v`. Tolerance 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.geometry import rotations as jrot  # noqa: E402
from tcdiff_torch import geometry  # noqa: E402
from tcdiff_torch.geometry import rotations as rot  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)


def _unit_quats(n: int, seed: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _pairs(n: int = 256, seed: int = 0):
    """(x, y) pairs: random, antipodal (y ~ -x: flipped onto x's arc),
    near-identical (1 - cos < 0.01: the linear blend) and near the branch's
    edge."""
    rng = np.random.default_rng(seed)
    x = _unit_quats(4 * n, seed)
    y = _unit_quats(4 * n, seed + 1)
    y[n:2 * n] = -x[n:2 * n] + 1e-3 * rng.normal(size=(n, 4))
    y[2 * n:3 * n] = x[2 * n:3 * n] + 1e-3 * rng.normal(size=(n, 4))
    y[3 * n:] = x[3 * n:] + rng.uniform(0.05, 0.3, size=(n, 1)) * rng.normal(size=(n, 4))
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    return x, y.astype(np.float32)


@pytest.mark.parametrize("weights", ["scalar", "per_element"])
def test_quat_slerp_matches_jax(weights):
    x, y = _pairs()
    cos = (x * y).sum(-1)
    assert (cos < -0.99).sum() >= 200 and (np.abs(1 - np.abs(cos)) < 0.01).sum() >= 400
    a = 0.3 if weights == "scalar" else np.random.default_rng(2).uniform(0, 1, size=len(x)).astype(np.float32)
    ref = np.asarray(jax.jit(jrot.quat_slerp)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a)))
    out = rot.quat_slerp(torch.from_numpy(x), torch.from_numpy(y), torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # the ends: a = 0 gives x, a = 1 gives y on x's arc
    ends = rot.quat_slerp(torch.from_numpy(x), torch.from_numpy(y), torch.tensor([[0.0], [1.0]])).numpy()
    np.testing.assert_allclose(ends[0], x, atol=1e-6)
    np.testing.assert_allclose(ends[1], np.where((cos < 0)[:, None], -y, y), atol=1e-6)


def test_quat_slerp_leaves_its_inputs():
    x, y = (torch.from_numpy(a) for a in _pairs(16))
    y0 = y.clone()
    rot.quat_slerp(x, y, 0.5)
    assert torch.equal(y, y0)


def _rotations(n: int = 512, seed: int = 0) -> np.ndarray:
    """Axis-angles with angles from 0 to pi, a quarter of them within 1e-3
    of pi."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.concatenate([rng.uniform(0, np.pi, n - n // 4), np.pi - rng.uniform(1e-5, 1e-3, n // 4)])
    return (axis * angle[:, None]).astype(np.float32)


def test_matrix_to_axis_angle_near_pi_matches_jax():
    m = np.array(jrot.axis_angle_to_matrix(jnp.asarray(_rotations())))
    ref = np.asarray(jax.jit(jrot.matrix_to_axis_angle)(jnp.asarray(m)))
    out = rot.matrix_to_axis_angle(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("name", ["ax_from_6v", "quat_from_6v"])
def test_from_6v_matches_jax(name):
    """6D from real rotations, then scaled and perturbed (Gram-Schmidt
    takes any two independent rows)."""
    rng = np.random.default_rng(3)
    d6 = np.array(jrot.ax_to_6v(jnp.asarray(_rotations(seed=1))))
    d6 = (d6 * rng.uniform(0.5, 2.0, size=(len(d6), 1)) + 0.05 * rng.normal(size=d6.shape)).astype(np.float32)
    ref = np.asarray(jax.jit(getattr(jrot, name))(jnp.asarray(d6)))
    out = getattr(rot, name)(torch.from_numpy(d6)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_quat_to_6v_matches_jax():
    q = _unit_quats(512, 4)
    ref = np.asarray(jax.jit(jrot.quat_to_6v)(jnp.asarray(q)))
    np.testing.assert_allclose(rot.quat_to_6v(torch.from_numpy(q)).numpy(), ref, **TOL)


def test_package_exports_the_conversions():
    for name in ("quat_slerp", "matrix_to_axis_angle", "quat_to_6v", "quat_from_6v", "ax_from_6v", "smpl_fk",
                 "SMPL_JOINTS"):
        assert hasattr(geometry, name), name
    from tcdiff_tpu.geometry.skeleton import SMPL_JOINTS

    assert geometry.SMPL_JOINTS == SMPL_JOINTS
