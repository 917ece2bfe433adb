"""The port's rotation conversions and SMPL FK against the JAX package's.

Seeded numpy 6D rotations and root positions go through both; f32 on the
CPU. Tolerance 2e-6 abs on the quaternions and 1e-5 abs on the joint
positions (metres, a chain of up to 8 rotations of offsets below 0.5 m):
the two differ only in f32 rounding order. The gradients of a scalar of
the positions are compared too, at 1e-4 abs (a sum over 24 joints of
products of those rounding differences).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.geometry.rotations import matrix_to_quaternion as jax_m2q  # noqa: E402
from tcdiff_tpu.geometry.rotations import rotation_6d_to_matrix as jax_6d2m  # noqa: E402
from tcdiff_tpu.geometry.skeleton import smpl_fk_from_6d as jax_fk  # noqa: E402
from tcdiff_torch.geometry.rotations import matrix_to_quaternion, rotation_6d_to_matrix  # noqa: E402
from tcdiff_torch.geometry.skeleton import smpl_fk_from_6d  # noqa: E402


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    d6 = rng.normal(size=(n, 24, 6)).astype(np.float32)
    root = rng.normal(size=(n, 3)).astype(np.float32)
    return d6, root


def test_rotation_6d_to_matrix_and_quaternion_match_jax():
    d6, _ = _inputs()
    m = rotation_6d_to_matrix(torch.from_numpy(d6))
    np.testing.assert_allclose(m.numpy(), np.asarray(jax_6d2m(jnp.asarray(d6))), atol=2e-6, rtol=0)
    q = matrix_to_quaternion(m)
    ref = np.asarray(jax_m2q(jax_6d2m(jnp.asarray(d6))))
    np.testing.assert_allclose(q.numpy(), ref, atol=2e-6, rtol=0)


def test_smpl_fk_from_6d_matches_jax_with_gradients():
    d6, root = _inputs(1)
    w = np.random.default_rng(2).normal(size=(24, 3)).astype(np.float32)

    def jloss(d6, root):
        return jnp.sum(jax_fk(d6, root) * w)

    ref = np.asarray(jax.jit(jax_fk)(jnp.asarray(d6), jnp.asarray(root)))
    jg6, jgr = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(d6), jnp.asarray(root))
    t6, tr = torch.tensor(d6, requires_grad=True), torch.tensor(root, requires_grad=True)
    pos = smpl_fk_from_6d(t6, tr)
    np.testing.assert_allclose(pos.detach().numpy(), ref, atol=1e-5, rtol=0)
    (pos * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t6.grad.numpy(), np.asarray(jg6), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr), atol=1e-4, rtol=0)
    assert np.isfinite(t6.grad.numpy()).all()
