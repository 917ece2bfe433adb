"""The port's export (tcdiff_torch/export) against the JAX package's, on
the CPU: from one FK pkl of `render_sample`, the per-dancer split pkls and
the BVH files are equal byte for byte; the FBX and Blender paths are gated
on their tools, which neither this machine nor the card's has."""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tcdiff_tpu.export import blender_launch as jblender  # noqa: E402
from tcdiff_tpu.export import bvh as jbvh  # noqa: E402
from tcdiff_tpu.export import split_pkl as jsplit  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402
from tcdiff_torch.export import blender_launch, bvh, fbx_export, split_pkl  # noqa: E402
from tcdiff_torch.viz.postprocess import render_sample  # noqa: E402

SEQ, DN = 12, 3


@pytest.fixture(scope="module")
def fk_pkl(tmp_path_factory):
    """One long-form FK pkl (3 slices stitched) written by the port."""
    out = tmp_path_factory.mktemp("fk")
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, size=(3, SEQ * DN, 151)).astype(np.float32)
    norm = Normalizer.fit(rng.normal(size=(4, SEQ, 151)).astype(np.float32), device="cpu")
    render_sample(torch.from_numpy(x), norm, "gen", str(out / "r"), DN, fk_out=str(out), name=["s_slice0.wav"] * 3,
                  sound=False, mode="long", render=False)
    return str(out / "gen_s.pkl")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_split_pkl_and_bvh_equal_jax_byte_for_byte(fk_pkl, tmp_path):
    ours = split_pkl.split_pkl_file(fk_pkl, str(tmp_path / "port"), "gen_s.pkl")
    ref = jsplit.split_pkl_file(fk_pkl, str(tmp_path / "jax"), "gen_s.pkl")
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref] == [f"gen_s/{i}.pkl" for i in range(DN)]
    frames = SEQ + SEQ // 2 * 2
    for a, b in zip(ours, ref):
        assert _bytes(a) == _bytes(b)
        with open(a, "rb") as f:
            sub = pickle.load(f)
        assert sub["smpl_poses"].shape == (frames, 72) and sub["smpl_trans"].shape == (frames, 3)
        assert sub["full_pose"].shape == (1, frames, 24, 3)
        out_a = bvh.pkl_to_bvh(a, str(tmp_path / "bvh_port"))
        out_b = jbvh.pkl_to_bvh(b, str(tmp_path / "bvh_jax"))
        assert os.path.basename(out_a) == os.path.basename(out_b) and _bytes(out_a) == _bytes(out_b)
    text = _bytes(out_a).decode()
    assert text.startswith("HIERARCHY\nROOT root") and f"Frames: {frames}\n" in text


def test_euler_conversion_equals_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    aa = np.concatenate([rng.normal(size=(200, 3)), np.zeros((2, 3)), 1e-9 * rng.normal(size=(2, 3)),
                         np.array([[np.pi / 2, 0, 0], [-np.pi / 2, 0, 0]])])
    np.testing.assert_array_equal(bvh._axis_angle_to_euler_zxy_deg(aa), jbvh._axis_angle_to_euler_zxy_deg(aa))


def test_split_pkl_cli(fk_pkl, tmp_path, capsys):
    split_pkl.main(["--input_dir", os.path.dirname(fk_pkl)])
    assert sorted(os.listdir(os.path.join(os.path.dirname(fk_pkl), "gen_s"))) == [f"{i}.pkl" for i in range(DN)]
    split_pkl.main(["--input_dir", str(tmp_path)])
    assert "No PKL files" in capsys.readouterr().out


def test_fbx_and_blender_are_gated(fk_pkl, tmp_path):
    assert not fbx_export.fbx_available() and not blender_launch.blender_available()
    with pytest.raises(ImportError, match="pkl_to_bvh"):
        fbx_export.pkl_to_fbx(fk_pkl, "template.fbx", str(tmp_path / "x.fbx"))
    with pytest.raises(RuntimeError, match="blender"):
        blender_launch.launch(str(tmp_path), str(tmp_path / "out"))
    script = blender_launch.write_blender_import_script(str(tmp_path / "s" / "import.py"))
    assert _bytes(script) == _bytes(jblender.write_blender_import_script(str(tmp_path / "j" / "import.py")))
    objs = fbx_export.SmplObjects(os.path.dirname(fk_pkl))
    assert len(objs) == 1 and next(iter(objs))[1]["smpl_poses"].shape[1] == 72
