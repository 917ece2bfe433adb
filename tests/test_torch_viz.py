"""The port's sample post-processing and renders (tcdiff_torch/viz)
against the JAX package's `viz/postprocess.py`, on the CPU, and the
renders' files.

`split_sample`, `stitch_long` (the half-window crossfade and the slerp),
and `render_sample` in normal and long mode with render=False: the FK pkl
files' names and keys equal, their arrays within 1e-5. Then a GIF written
by `skeleton_render` and by `traj_render` (matplotlib), and the DBN
trainer's render=True writing its GIFs and trajectory pkls.
"""

import functools
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.data.normalizer import Normalizer as JaxNormalizer  # noqa: E402
from tcdiff_tpu.viz import postprocess as jpost  # noqa: E402
from tcdiff_torch.config import TrajDecoderConfig  # noqa: E402
from tcdiff_torch.data.normalizer import Normalizer  # noqa: E402
from tcdiff_torch.trajdecoder import trainer as trainer_mod  # noqa: E402
from tcdiff_torch.trajdecoder.dataset import SyntheticTrajDataset  # noqa: E402
from tcdiff_torch.viz import postprocess as post  # noqa: E402
from tcdiff_torch.viz.render import skeleton_render  # noqa: E402
from tcdiff_torch.viz.traj_render import render_traj_sample, traj_render  # noqa: E402

SEQ, DN, NF = 16, 3, 151
TOL = dict(atol=1e-5, rtol=1e-5)


def _samples(b: int, seed: int) -> np.ndarray:
    """(b, SEQ*DN, 151) normalized samples, uniform in [-0.9, 0.9]."""
    return np.random.default_rng(seed).uniform(-0.9, 0.9, size=(b, SEQ * DN, NF)).astype(np.float32)


@pytest.fixture(scope="module")
def norms():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(8, SEQ, NF)).astype(np.float32)
    data[..., 7:] = rng.uniform(-1, 1, size=data[..., 7:].shape)  # the 6D columns
    jn = JaxNormalizer.fit(jnp.asarray(data))
    st = jn.to_numpy()
    return jn, Normalizer.from_torch_state(st["scale"], st["offset"], device="cpu")


def test_split_sample_matches_jax(norms):
    jn, tn = norms
    x = _samples(2, 0)
    ours = post.split_sample(torch.from_numpy(x), tn, DN)
    ref = jpost.split_sample(jnp.asarray(x), jn, DN)
    assert [o.shape for o in ours] == [(2, SEQ, DN, 4), (2, SEQ * DN, 3), (2, SEQ * DN, 24, 3)]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_stitch_long_matches_jax(b):
    rng = np.random.default_rng(b)
    pos = rng.normal(size=(b, SEQ, DN, 3)).astype(np.float32)
    q = rng.normal(size=(b, SEQ, DN, 24, 3)).astype(np.float32)
    fp, fq = post.stitch_long(torch.from_numpy(pos), torch.from_numpy(q))
    rp, rq = jpost.stitch_long(pos, q)
    assert fp.shape == (SEQ + SEQ // 2 * (b - 1), DN, 3) and fq.shape == fp.shape[:2] + (24, 3)
    np.testing.assert_allclose(fp.numpy(), rp, **TOL)
    np.testing.assert_allclose(fq.numpy(), rq, **TOL)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("mode", ["normal", "long"])
def test_render_sample_pkls_match_jax(norms, tmp_path, mode):
    """Three samples (long: three slices of one song): the returned joints
    and every pkl's smpl_poses, smpl_trans and full_pose."""
    jn, tn = norms
    x = _samples(3, 2)
    names = [f"/data/wavs/song_a_slice{i}.wav" for i in range(3)]
    ref = jpost.render_sample(jnp.asarray(x), jn, 5, str(tmp_path / "jr"), DN, fk_out=str(tmp_path / "jax"),
                              name=names, sound=False, mode=mode, render=False)
    ours = post.render_sample(torch.from_numpy(x), tn, 5, str(tmp_path / "tr"), DN, fk_out=str(tmp_path / "port"),
                              name=names, sound=False, mode=mode, render=False)
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **TOL)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert files == (["5_song_a.pkl"] if mode == "long" else [f"5_{i}_song_a_slice{i}.pkl" for i in range(3)])
    for name in files:
        a, b = _load(tmp_path / "port" / name), _load(tmp_path / "jax" / name)
        assert sorted(a) == sorted(b) == ["full_pose", "smpl_poses", "smpl_trans"]
        for k in b:
            assert a[k].shape == np.asarray(b[k]).shape and a[k].dtype == np.float32, k
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    frames = SEQ + SEQ // 2 * 2 if mode == "long" else SEQ
    assert a["smpl_poses"].shape == (frames * DN, 72) and a["full_pose"].shape == (DN, frames, 24, 3)
    assert not os.path.exists(tmp_path / "tr")  # render=False draws nothing


def test_render_sample_draws_gifs(norms, tmp_path):
    _, tn = norms
    x = _samples(2, 3)
    post.render_sample(torch.from_numpy(x[:, :4 * DN]), tn, 1, str(tmp_path), DN, name=["a.wav", "b.wav"],
                       sound=False)
    assert sorted(os.listdir(tmp_path)) == ["e1_b0_a.gif", "e1_b1_b.gif"]


def test_skeleton_render_writes_a_gif(tmp_path):
    poses = np.random.default_rng(4).normal(size=(2, 5, 24, 3)).astype(np.float32)
    assert skeleton_render(poses, epoch=3, out=str(tmp_path), name="x.wav", sound=False, render=False) is None
    path = skeleton_render(poses, epoch=3, out=str(tmp_path), name="x.wav", sound=False)
    assert path == os.path.join(str(tmp_path), "3_x.gif")
    with open(path, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")


def test_traj_render_writes_a_gif_and_pkls(tmp_path):
    trajs = np.random.default_rng(5).normal(size=(3, 2, 6, 2)).cumsum(2).astype(np.float32)
    path = traj_render(trajs[0], str(tmp_path), epoch=2, name="s.wav")
    assert path == os.path.join(str(tmp_path), "traj_2_s.gif") and os.path.getsize(path) > 0
    written = render_traj_sample(trajs, str(tmp_path / "r"), epoch=7, names=["a.wav", "b.wav", "c.wav"],
                                 pkl_out=str(tmp_path / "p"), max_renders=1)
    assert sorted(os.path.basename(p) for p in written) == ["7_a.pkl", "7_b.pkl", "7_c.pkl", "traj_7_a.gif"]
    trans = _load(tmp_path / "p" / "7_b.pkl")["smpl_trans"]
    np.testing.assert_array_equal(trans[..., :2], trajs[1])
    assert trans.shape == (2, 6, 3) and not trans[..., 2].any()


def test_dbn_trainer_render_writes_its_files(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "MetricLogger", functools.partial(
        trainer_mod.MetricLogger, use_wandb=False, use_tensorboard=False))
    cfg = TrajDecoderConfig(window_size=8, step=4, trans_layer=1, latent_dim=16, n_head=2, total_iter=2,
                            print_iter=2, batch_size=4)
    trainer = trainer_mod.TrajTrainer(cfg, dancer_num=2, device="cpu")
    train_ds = SyntheticTrajDataset(6, 2, seq_len=16, seed=0, device="cpu")
    test_ds = SyntheticTrajDataset(3, 2, seq_len=16, seed=1, normalizer=train_ds.normalizer, device="cpu")
    trainer.train(train_ds, test_ds, out_dir=str(tmp_path), render=True)
    gifs = sorted(os.listdir(tmp_path / "renders"))
    pkls = sorted(os.listdir(tmp_path / "traj_pkl"))
    assert len(gifs) == 2 and all(g.startswith("traj_2_") and g.endswith(".gif") for g in gifs)
    assert len(pkls) == 3 and sorted(trainer.renders) == sorted(
        [str(tmp_path / "renders" / g) for g in gifs] + [str(tmp_path / "traj_pkl" / p) for p in pkls])
    trans = _load(tmp_path / "traj_pkl" / pkls[0])["smpl_trans"]
    assert trans.shape == trainer.last_eval.shape[1:3] + (3,)
