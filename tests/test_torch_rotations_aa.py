"""The port's axis-angle rotation conversions and axis-angle FK against the
JAX package's, on the CPU in f32.

Angles include zero, values below the 1e-6 Taylor switch, ordinary ones and
values near pi (where the quaternion's w vanishes and axis-angle ->
quaternion -> axis-angle is least stable). Tolerances: 1e-6 for each
conversion (a few f32 roundings apart), 1e-5 for FK (24 joints chained).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.geometry import rotations as jrot  # noqa: E402
from tcdiff_tpu.geometry import skeleton as jskel  # noqa: E402
from tcdiff_torch.geometry import rotations as rot  # noqa: E402
from tcdiff_torch.geometry import skeleton as skel  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)


def _axis_angles(n: int = 512, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.concatenate([
        np.zeros(8), rng.uniform(0, 1e-6, 56), rng.uniform(1e-6, 1e-4, 64), rng.uniform(0, np.pi, n - 256),
        np.pi - rng.uniform(0, 1e-3, 128),
    ])
    return (axis * angle[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", ["axis_angle_to_quaternion", "axis_angle_to_matrix", "ax_to_6v"])
def test_from_axis_angle_matches_jax(name):
    aa = _axis_angles()
    ref = np.asarray(jax.jit(getattr(jrot, name))(jnp.asarray(aa)))
    out = getattr(rot, name)(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_quaternion_conversions_match_jax():
    aa = _axis_angles(seed=1)
    q = np.array(jrot.axis_angle_to_quaternion(jnp.asarray(aa)))
    q_scaled = (q * np.linspace(0.5, 2.0, len(q))[:, None]).astype(np.float32)  # the matrix takes any norm
    np.testing.assert_allclose(rot.quaternion_to_matrix(torch.from_numpy(q_scaled)).numpy(),
                               np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q_scaled))), **TOL)
    back = rot.quaternion_to_axis_angle(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(back, np.asarray(jrot.quaternion_to_axis_angle(jnp.asarray(q))), atol=1e-5,
                               rtol=1e-6)
    # the round trip returns the angle off pi (near pi an f32 quaternion's
    # w holds the angle to ~1e-4; both packages lose the same)
    off_pi = np.linalg.norm(aa, axis=-1) < 3.0
    np.testing.assert_allclose(back[off_pi], aa[off_pi], atol=1e-5)
    m = rot.axis_angle_to_matrix(torch.from_numpy(aa))
    np.testing.assert_allclose(rot.matrix_to_rotation_6d(m).numpy(),
                               np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m.numpy()))), atol=0, rtol=0)


def test_quaternion_to_axis_angle_small_angles_take_the_taylor_branch():
    aa = np.array([[0.0, 0.0, 0.0], [3e-7, -2e-7, 1e-7], [1e-6, 0, 0]], np.float32)
    q = rot.axis_angle_to_quaternion(torch.from_numpy(aa))
    assert torch.isfinite(q).all()
    np.testing.assert_allclose(rot.quaternion_to_axis_angle(q).numpy(), aa, atol=1e-9)
    g = torch.zeros(3, 3, requires_grad=True)
    rot.axis_angle_to_quaternion(g).sum().backward()
    assert torch.isfinite(g.grad).all()


def test_smpl_fk_from_axis_angle_matches_jax():
    rng = np.random.default_rng(2)
    rots = (rng.normal(size=(2, 3, 5, 24, 3)) * 0.6).astype(np.float32)
    rots[0, 0, 0, 3] = 0.0  # one identity joint
    root = rng.normal(size=(2, 3, 5, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jskel.smpl_fk)(jnp.asarray(rots), jnp.asarray(root)))
    out = skel.smpl_fk(torch.from_numpy(rots), torch.from_numpy(root)).numpy()
    assert out.shape == (2, 3, 5, 24, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
