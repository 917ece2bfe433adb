"""The port's `TCDiff` loops of `val_without_TrajModel` (normal, long,
footwork and ddpm sampling) and `test` (the DBN trajectory stage, then
the sampler) against the JAX package's `TCDiff`, on the CPU, on the set-up
of tests/_torch_tcdiff.py (injected sampler noise, shared weights).

Tolerances: the samples each loop renders 3e-5; the FK pkls written from
them 1e-4 (6D -> axis-angle and the FK chain widen the samples'
differences).
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_tcdiff import TOL, build_stack, jorch, loop_opt, orch  # noqa: E402


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    return build_stack(tmp_path_factory.mktemp("dbn"))


@pytest.fixture
def rendered(monkeypatch):
    """The samples each side's loops hand to render_sample, by side."""
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jorch), ("port", orch)):
        def record(samples, *a, _side=side, _orig=mod.render_sample, **k):
            seen[_side].append(np.asarray(samples))
            return _orig(samples, *a, **k)

        monkeypatch.setattr(mod, "render_sample", record)
    return seen


def _same_pkls(tmp_path, count: int, rendered):
    assert len(rendered["port"]) == len(rendered["jax"]) > 0
    for a, b in zip(rendered["port"], rendered["jax"]):
        np.testing.assert_allclose(a, b, **TOL)
    files = sorted(os.listdir(tmp_path / "jax" / "fk"))
    assert sorted(os.listdir(tmp_path / "port" / "fk")) == files and len(files) == count
    for name in files:
        with open(tmp_path / "port" / "fk" / name, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "jax" / "fk" / name, "rb") as f:
            b = pickle.load(f)
        for k in ("smpl_poses", "smpl_trans", "full_pose"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=1e-4, err_msg=f"{name} {k}")


@pytest.mark.parametrize("mode", ["normal", "long", "footwork", "ddpm"])
def test_val_without_traj_model_matches_jax(stack, tmp_path, mode, rendered):
    jr, pr, jds, pds, _ = stack
    jr.given_trajectory_generation_loop(loop_opt(tmp_path, "jax", sample_mode=mode), test_ds=jds)
    pr.given_trajectory_generation_loop(loop_opt(tmp_path, "port", sample_mode=mode), test_ds=pds)
    _same_pkls(tmp_path, 1 if mode == "long" else 4, rendered)


def test_test_loop_matches_jax(stack, tmp_path, rendered, monkeypatch):
    jr, pr, jds, pds, pt = stack
    monkeypatch.setattr(pr, "cfg", dataclasses.replace(pr.cfg, train=dataclasses.replace(pr.cfg.train, epochs=2)))
    jr.test_loop(loop_opt(tmp_path, "jax", epochs=2), test_ds=jds)
    pr.test_loop(loop_opt(tmp_path, "port", traj_checkpoint=pt), test_ds=pds)
    _same_pkls(tmp_path, 8, rendered)


def test_consecutive_slice_indices_match_jax():
    files = [f"a_slice{i}.npy" for i in (0, 1, 3, 4, 5)] + [f"b_slice{i}.npy" for i in (2, 3)] + ["c.npy"]
    for count in (1, 2, 3, 5):
        assert orch.consecutive_slice_indices(files, count) == jorch.consecutive_slice_indices(files, count)
