"""Shared set-up of tests/test_torch_tcdiff*.py: the port's `TCDiff` and
the JAX package's, on the same weights, normalizer, data and injected
sampler noise.

The JAX side is its own `TCDiff` with only what the loops read (as in
tests/test_torch_generate.py), the DBN's weights shared (a reference `.pt`
for the port). Tiny configuration after tests/test_orchestrator.py's
`_tiny_cfg` (1 layer, d=32, 16 frames x 2 dancers, 2 DDIM steps over 10
timesteps), f32; the decoder's weights perturbed from their init and its
final layer scaled by 0.1.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tcdiff_tpu import config as jcfg
from tcdiff_tpu.data.normalizer import Normalizer as JaxNormalizer
from tcdiff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from tcdiff_tpu.models import DanceDecoder as JaxDecoder
from tcdiff_tpu.train import orchestrator as jorch
from tcdiff_tpu.trajdecoder.model import TrajDecoder as JaxTrajDecoder
from tcdiff_torch import config as tcfg
from tcdiff_torch.cli.args import build_parser
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.interop.from_jax import load_jax_params, load_jax_traj_params
from tcdiff_torch.train import orchestrator as orch
from tcdiff_torch.trajdecoder.model import TrajDecoder

SEQ, DN, NF = 16, 2, 151
MODEL = dict(seq_len=SEQ, latent_dim=32, ff_size=32, num_layers=1, num_heads=2, cond_feature_dim=438,
             dancer_num=DN, head_dim=16)
DIFF = dict(sampling_timesteps=2, n_timestep=10, footwork_frames=(4, 12), footwork_blend_width=2)
TRAJ = dict(window_size=8, step=4, trans_layer=1, latent_dim=16)
TRAIN = dict(batch_size=4, save_interval=1, epochs=1)
TOL = dict(atol=3e-5, rtol=3e-5)


def cfgs():
    """(JAX config, port config): the same fields."""
    return (jcfg.TCDiffConfig(model=jcfg.DanceDecoderConfig(**MODEL), diffusion=jcfg.DiffusionConfig(**DIFF),
                              train=jcfg.TrainConfig(**TRAIN, dp=1), traj=jcfg.TrajDecoderConfig(**TRAJ)),
            tcfg.TCDiffConfig(model=tcfg.DanceDecoderConfig(**MODEL), diffusion=tcfg.DiffusionConfig(**DIFF),
                              train=tcfg.TrainConfig(**TRAIN), traj=tcfg.TrajDecoderConfig(**TRAJ)))


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


class Dataset:
    """An AIOZDataset-shaped test split: n slices, runs of 4 consecutive
    slices of one song (long mode), a beat every ~8 music frames."""

    def __init__(self, n: int, normalizer, seed: int):
        rng = np.random.default_rng(seed)
        self.poses = rng.uniform(-0.9, 0.9, size=(n, DN, SEQ, NF)).astype(np.float32)
        self.music = rng.normal(size=(n, 2 * SEQ + 1, 438)).astype(np.float32)
        self.music[..., 53] = 0.0
        self.music[:, 3::8, 53] = 1.0
        self.normalizer = normalizer
        self.feature_files = [f"/d/song{i // 4}_slice{i % 4}.npy" for i in range(n)]
        self.wav_files = [f.replace(".npy", ".wav") for f in self.feature_files]

    def __len__(self):
        return len(self.poses)

    def get(self, idx):
        return self.poses[idx], self.music[idx], self.feature_files[idx], self.wav_files[idx]

    def batches(self, batch_size, rng=None, drop_last=True):
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield {"x": self.poses[idx], "cond": self.music[idx], "filename": [self.feature_files[j] for j in idx],
                   "wav": [self.wav_files[j] for j in idx]}


def _noise(shape, steps: int) -> dict:
    rng = np.random.default_rng(shape[0] * 7 + steps)
    return {"init": rng.normal(size=shape).astype(np.float32),
            "steps": rng.normal(size=(steps,) + tuple(shape)).astype(np.float32)}


class JaxRunner(jorch.TCDiff):
    """The JAX package's TCDiff with only what its loops read, its
    samplers given injected noise."""

    def __init__(self, cfg, params, traj_params, normalizer):
        self.cfg, self.normalizer, self.logger = cfg, normalizer, logging.getLogger("tcdiff_tpu")
        self.diffusion = JaxDiffusion(JaxDecoder(cfg.model), cfg.diffusion)
        self.mesh = types.SimpleNamespace(shape={"dp": 1})
        self.eval_params = lambda: params
        self._load_traj_params = lambda opt, model: traj_params
        d, s, t = self.diffusion, cfg.diffusion.sampling_timesteps, cfg.diffusion.n_timestep
        ddim, long = (jax.jit(f, static_argnums=(1,)) for f in (d.ddim_sample, d.long_ddim_sample))
        self._sample_fn = lambda p, shape, cond, rng, x_0: ddim(p, shape, cond, rng, x_0, _noise(shape, s))
        self._long_sample_fn = lambda p, shape, cond, rng, x_0: long(p, shape, cond, rng, x_0, _noise(shape, s))
        fw, ddpm = d.ddim_sample_footwork, d.p_sample_loop
        d.ddim_sample_footwork = lambda p, shape, cond, rng, x_0: fw(p, shape, cond, rng, x_0, _noise(shape, s))
        d.p_sample_loop = lambda p, shape, cond, rng: ddpm(p, shape, cond, rng, _noise(shape, t))


def inject(runner: orch.TCDiff) -> None:
    """The port's samplers given the same injected noise."""
    d, s, t = runner.diffusion, runner.cfg.diffusion.sampling_timesteps, runner.cfg.diffusion.n_timestep
    for name, steps in (("ddim_sample", s), ("long_ddim_sample", s), ("ddim_sample_footwork", s),
                        ("p_sample_loop", t)):
        orig = getattr(d, name)
        setattr(d, name, lambda shape, cond, generator=None, _o=orig, _n=steps, **kw:
                _o(shape, cond, generator, noise=_noise(shape, _n), **kw))


def build_stack(tmp_dir):
    """(JAX runner, port runner, JAX test split, port test split, DBN .pt
    written under tmp_dir) on the same weights, normalizer and data."""
    jc, pc = cfgs()
    params = jax.jit(JaxDecoder(jc.model).init)(jax.random.key(0), jnp.zeros((1, SEQ * DN, NF)),
                                                jnp.zeros((1, 2 * SEQ + 1, 438)), jnp.zeros((1,), jnp.int32))["params"]
    params = _perturbed(params, 9)
    params = dict(params, final_layer={k: 0.1 * v for k, v in params["final_layer"].items()})
    w, s = TRAJ["window_size"], TRAJ["step"]
    traj_params = _perturbed(jax.jit(JaxTrajDecoder(jc.traj).init)(
        jax.random.key(3), jnp.zeros((1, DN, w, 2)), jnp.zeros((1, (w + s) * 2, 438)))["params"], 3)
    rng = np.random.default_rng(11)
    jnorm = JaxNormalizer.fit(jnp.asarray(rng.normal(size=(8, SEQ, NF)).astype(np.float32) * 2))
    st = jnorm.to_numpy()
    pnorm = Normalizer.from_torch_state(st["scale"], st["offset"], device="cpu")

    runner = orch.TCDiff(pc, device="cpu")
    load_jax_params(runner.model, params)
    for name, p in runner.model.named_parameters():
        runner.state.ema_params[name] = p.detach().clone()
    runner.normalizer = pnorm
    inject(runner)
    traj_model = load_jax_traj_params(TrajDecoder(pc.traj, device="cpu"), traj_params)
    pt = str(tmp_dir / "dbn.pt")
    torch.save({"net": traj_model.state_dict()}, pt)
    return (JaxRunner(jc, params, traj_params, jnorm), runner, Dataset(8, jnorm, 5), Dataset(8, pnorm, 5), pt)


def parsed_opt(**kw):
    """The flags of `cli.train` at their parser defaults, `kw` set over them."""
    return types.SimpleNamespace(**{**vars(build_parser().parse_args([])), **kw})


def loop_opt(tmp_path, side: str, **kw):
    """One side's flags, its outputs under tmp_path/side. The port's loops
    count their rounds from cfg.train.epochs; the JAX package's from
    `epochs` here."""
    return parsed_opt(**{**dict(render=False, vis_fk_out=str(tmp_path / side / "fk"),
                                render_dir=str(tmp_path / side / "r"), exp_name="e",
                                project=str(tmp_path / side / "runs"), epochs=1, render_count=4), **kw})


