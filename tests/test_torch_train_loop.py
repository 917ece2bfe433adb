"""The port's denoiser train loop (`train/orchestrator.py`: `load_datasets`,
`train_loop`) on the CPU, over a tiny AIOZ tree on disk.

The tree holds motion slices (the synthetic motion's draws) and feats438
files written directly from `synthetic_music`, which skips the feature
extraction, and its slices are 16 frames long (the loop takes any
length). The model is small (1 layer, d=64, 4 heads, 16 frames x 2
dancers, 438 music channels, dropout 0), initialised in flax, perturbed
and loaded into the port; on CPU tensors the train kernels run their plain
versions. The first step's loss terms are held against the JAX
package's `p_losses` (the loss of its train step) on the same batch, t,
noise and keep mask, at `tests/test_torch_train.py`'s tolerance for them:
3e-5 with t < 64.
"""

import functools
import hashlib
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig  # noqa: E402
from tcdiff_torch.data.dataset import AIOZDataset  # noqa: E402
from tcdiff_torch.data.synthetic import synthetic_motion, synthetic_music  # noqa: E402
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion  # noqa: E402
from tcdiff_torch.interop.from_jax import load_jax_params  # noqa: E402
from tcdiff_torch.models.dance_decoder import DanceDecoder  # noqa: E402
from tcdiff_torch.optim.adan import Adan  # noqa: E402
from tcdiff_torch.train import orchestrator  # noqa: E402
from tcdiff_torch.train.state import create_train_state  # noqa: E402
from tcdiff_torch.train.train_step import make_train_step  # noqa: E402
from tcdiff_torch.utils.checkpoint import latest_checkpoint, restore_train_state  # noqa: E402

SEQ = 16  # frames a slice (the AIOZ slices hold 150; the loop takes any)
CFG_KW = dict(nfeats=151, seq_len=SEQ, latent_dim=64, ff_size=64, num_layers=1, num_heads=4, dropout=0.0,
              cond_feature_dim=438, dancer_num=2)
MCFG, JMCFG = DanceDecoderConfig(**CFG_KW), JaxDecoderConfig(**CFG_KW)
DCFG, JDCFG = DiffusionConfig(), JaxDiffusionConfig()
LR, WD = 1e-3, 0.02


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    """The metrics to JSONL alone: importing TensorBoard here pulls in
    TensorFlow (~14 s)."""
    monkeypatch.setattr(orchestrator, "MetricLogger", functools.partial(
        orchestrator.MetricLogger, use_wandb=False, use_tensorboard=False))


def _write_tree(root, split, names, slices=2, seed=0):
    """`{split}/motions_sliced` and `{split}/feats438` of `slices` slices a
    sequence, 2 dancers, written directly."""
    (root / split / "motions_sliced").mkdir(parents=True)
    (root / split / "feats438").mkdir(parents=True)
    for i, name in enumerate(names):
        pos, q = synthetic_motion(slices, 2, SEQ, seed=seed + i)
        feats = synthetic_music(slices, 2 * SEQ + 1, seed=seed + 10 + i)
        for k in range(slices):
            with open(root / split / "motions_sliced" / f"{name}_slice{k}.pkl", "wb") as f:
                pickle.dump({"pos": pos[k], "q": q[k]}, f)
            np.save(root / split / "feats438" / f"{name}_slice{k}.npy", feats[k])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("aioz_tl")
    _write_tree(root, "train", ("seq_a", "seq_b"))
    _write_tree(root, "test", ("seq_c",), seed=20)
    return root


@pytest.fixture(scope="module")
def params():
    jmodel = JaxDecoder(JMCFG)
    p = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, MCFG.tokens, 151)), jnp.zeros((1, 2 * SEQ + 1, 438)),
                             jnp.zeros((1,), jnp.int32))["params"]
    prng = np.random.default_rng(9)
    return jmodel, jax.tree.map(lambda a: np.asarray(a) + 0.05 * prng.normal(size=a.shape).astype(np.float32), p)


def _port_state(params):
    model = load_jax_params(DanceDecoder(MCFG, device="cpu"), params)
    opt = Adan(model.parameters(), lr=LR, weight_decay=WD)
    step = make_train_step(GaussianDiffusion(model, DCFG, device="cpu"), opt, ema_beta=0.9, device="cpu")
    return create_train_state(model, opt), step


def test_load_datasets_caches_by_dancers_and_split(tree, tmp_path, monkeypatch):
    opt = types.SimpleNamespace(data_path=str(tree), processed_data_dir=str(tmp_path), split_file=None)
    train, test = orchestrator.load_datasets(opt, dancer_num=2, device="cpu")
    assert len(train) == 4 and len(test) == 2
    assert sorted(os.listdir(tmp_path)) == ["test_dn2_all.npz", "train_dn2_all.npz"]
    split = tmp_path / "split.txt"
    split.write_text("seq_b\nseq_a\nseq_c\n")
    key = hashlib.sha1("seq_a\nseq_b\nseq_c".encode()).hexdigest()[:8]  # the JAX package's key
    assert orchestrator.cache_paths(str(tmp_path), 2, ["seq_b", "seq_a", "seq_c"])[0].endswith(
        f"train_dn2_{key}.npz")

    class CacheOnly:
        from_cache = staticmethod(AIOZDataset.from_cache)

        def __init__(self, *args, **kwargs):
            raise AssertionError("the cache should have served")

    monkeypatch.setattr(orchestrator, "AIOZDataset", CacheOnly)
    again, _ = orchestrator.load_datasets(opt, dancer_num=2, device="cpu")
    np.testing.assert_array_equal(again.poses, train.poses)
    assert again.feature_files == train.feature_files
    monkeypatch.setattr(orchestrator, "AIOZDataset", AIOZDataset)
    opt.split_file = str(split)
    fresh, _ = orchestrator.load_datasets(opt, dancer_num=2, device="cpu")
    assert len(fresh) == 4 and os.path.exists(tmp_path / f"train_dn2_{key}.npz")
    synth, synth_test = orchestrator.load_datasets(types.SimpleNamespace(synthetic=True, synthetic_size=4),
                                                   dancer_num=2, seq_len=16, device="cpu")
    assert synth.poses.shape == (4, 2, 16, 151) and len(synth_test) == 2


def test_train_loop_matches_jax_and_restores(tree, params, tmp_path):
    jmodel, jparams = params
    train_ds = AIOZDataset(str(tree), train=True, required_dancer_num=2, device="cpu")
    state, port_step = _port_state(jparams)
    jd = JaxDiffusion(jmodel, JDCFG)
    jloss = jax.jit(lambda p, x, c, t, noise, keep: jd.p_losses(p, x, c, t, jax.random.key(3), noise=noise,
                                                                keep_mask=keep))
    seen = []

    def step(state, x, cond, generator):
        """The first step on injected t (< 64), noise and keep mask, its
        batch also through the JAX package's loss."""
        if state.step > 0:
            return port_step(state, x, cond, generator)
        rng = np.random.default_rng(4)
        t = rng.integers(0, 64, size=x.shape[0]).astype(np.int32)
        noise = rng.normal(size=(x.shape[0], SEQ, 2, 151)).astype(np.float32)
        keep = np.array([True, False])
        seen.append(jloss(jparams, jnp.asarray(x.numpy()), jnp.asarray(cond.numpy()), t, noise, keep))
        state, m = port_step(state, x, cond, generator, t=torch.from_numpy(t), noise=torch.from_numpy(noise),
                             keep_mask=torch.from_numpy(keep))
        seen.append(m)
        return state, m

    out = orchestrator.train_loop(state, step, train_ds, str(tmp_path), epochs=2, batch_size=2, save_interval=1)
    assert out["steps"] == state.step == 4 and out["loader"] == "native"
    (jtotal, jparts), m = seen
    for k in ("recon", "velocity", "fk", "foot"):
        np.testing.assert_allclose(m[k].item(), float(jparts[k]), atol=3e-5, rtol=3e-5, err_msg=k)
    np.testing.assert_allclose(m["total"].item(), float(jtotal), atol=3e-5, rtol=3e-5)
    assert np.isfinite(out["metrics"]["total"]) and out["metrics"]["epoch"] == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert [os.path.basename(p) for p in out["checkpoints"]] == ["ckpt_2.pt", "ckpt_4.pt"]
    assert latest_checkpoint(str(tmp_path / "checkpoints")) == out["checkpoints"][-1]

    fresh, _ = _port_state(jparams)
    fresh, norm = restore_train_state(out["checkpoints"][-1], fresh)
    assert fresh.step == 4
    assert torch.equal(norm.scale, train_ds.normalizer.scale) and torch.equal(norm.offset, train_ds.normalizer.offset)
    named = dict(fresh.model.named_parameters())
    for name, p in state.model.named_parameters():
        assert torch.equal(named[name], p), name
        assert torch.equal(fresh.ema_params[name], state.ema_params[name]), name
        for k in ("m", "v", "n", "prev_grad"):
            assert torch.equal(fresh.optimizer.state[named[name]][k], state.optimizer.state[p][k]), (name, k)
    assert fresh.optimizer.param_groups[0]["step"] == state.optimizer.param_groups[0]["step"] == 4


def test_non_finite_loss_halts_with_a_rescue_checkpoint(tree, params, tmp_path):
    _, jparams = params
    train_ds = AIOZDataset(str(tree), train=True, required_dancer_num=2, device="cpu")
    train_ds.poses = train_ds.poses.copy()
    train_ds.poses[:, 0, 3, 10] = np.nan  # every sample poisoned
    state, step = _port_state(jparams)
    with pytest.raises(FloatingPointError):
        orchestrator.train_loop(state, step, train_ds, str(tmp_path), epochs=1, batch_size=2, save_interval=1)
    assert os.path.exists(tmp_path / "checkpoints" / "ckpt_1.pt")


def test_synthetic_data_loads_without_the_prefetcher(params, tmp_path):
    _, jparams = params
    train_ds, _ = orchestrator.load_datasets(types.SimpleNamespace(synthetic=True, synthetic_size=2),
                                             dancer_num=2, seq_len=SEQ, device="cpu")
    state, step = _port_state(jparams)
    out = orchestrator.train_loop(state, step, train_ds, str(tmp_path), epochs=1, batch_size=2, save_interval=5)
    assert out["loader"] == "numpy" and out["steps"] == 1 and out["checkpoints"] == []
