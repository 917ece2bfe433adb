"""Configuration types and constants of the port.

A copy of the dataclasses and constants `tcdiff_tpu/config.py` defines for
the denoiser, the diffusion, the trainer, the DBN, the data paths and the
bundle of them all (same defaults, and only the fields the port reads), so
that the port runs where JAX is not installed; and `ServingKernels`, the
port's form of the environment flags that choose the JAX package's serving
path.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DanceDecoderConfig:
    """Denoiser network."""

    nfeats: int = 151  # 4 contacts + 3 root + 24*6 rot6d
    seq_len: int = 150  # 5 s @ 30 FPS
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 8
    dropout: float = 0.1
    cond_feature_dim: int = 438  # librosa 438-d music features @ 60 FPS
    dancer_num: int = 3
    max_dancers: int = 10  # size of the shared trajectory embedding table
    head_dim: int = 64  # SBI-MSA per-head projection dim (d_k)

    @property
    def tokens(self) -> int:
        return self.seq_len * self.dancer_num


def _env_flag(environ, name: str, default: bool) -> bool:
    v = environ.get(name)
    return default if v is None else v == "1"


# the block flags a TCDIFF_INT8 serving run found set to 1 (warned once each)
_WARNED_INT8_SHADOW = set()


@dataclasses.dataclass(frozen=True)
class ServingKernels:
    """Which kernels the deterministic (serving) forward runs: one field
    per flag of the JAX package's serving path. The defaults are that
    package's TPU defaults: the self-attention block (K1) and the FF block
    with its tail (K2) on, FiLM outside the block kernels, the per-op
    kernels off, the cross-attention k/v hoisted. A site whose kernel is
    off runs as plain PyTorch math, the counterpart of the JAX package's
    XLA code there.

    `ca_block` (TCDIFF_PALLAS_XAB) is K7 at the cross-attention site, in
    the form the site takes: over the hoisted k/v (`ops.ca_block.ca_kv`,
    the FiLM residual inside) or, with the k/v cache off, over the memory
    (`ops.ca_block.ca_block`). Unset, it is on unless the plain site is
    the configuration's point: off under `int8` (the plain site's fc is
    int8) and in the per-op configuration (`ln_rotary`, `attention` or
    `layernorm` on: K8, K11 and K10 take that site's pieces). So, unlike
    the JAX package, whose XLA code runs the site over the hoisted k/v,
    the default runs K7 there.

    `int8` (TCDIFF_INT8) runs the decoder layers' projections on the plain
    sites through `ops.int8.int8_dense` (per-channel int8 weights,
    per-token int8 activations, int32 sums). With it on, `sa_block`,
    `ff_block`, `ff_tail` and `ca_block` default to off, as the JAX
    package's `_flag_default_on_tpu` turns them off, so that the int8
    projections are not shadowed by the bf16 block kernels; one set to
    True explicitly still wins, with a one-time warning.

    Every combination runs: the port has each kernel a combination selects.
    The rule stays that a combination whose kernel were missing would raise,
    never fall back to another path; none is left.
    """

    sa_block: Optional[bool] = None  # TCDIFF_PALLAS_SAB: K1 (None: on, off under int8)
    ff_block: Optional[bool] = None  # TCDIFF_PALLAS_FFB: K2 with ff_tail, K2b without (None: as sa_block)
    ff_tail: Optional[bool] = None  # TCDIFF_PALLAS_FFT (None: as sa_block)
    fuse_film: bool = False  # TCDIFF_FUSE_FILM: the FiLM residual inside K1, K2b and K7
    layernorm: bool = False  # TCDIFF_PALLAS_LN: K10, the SBI-MSA post-LayerNorms
    ln_matmul: bool = False  # TCDIFF_PALLAS_LNMM: K9, norm3->linear1 and norm4->linear3
    ln_rotary: bool = False  # TCDIFF_PALLAS_LNROT: K8, norm->rotary->projections
    attention: int = 0  # TCDIFF_PALLAS_ATTENTION: K11; 1 per head, 2 all heads
    kv_cache: bool = True  # TCDIFF_KV_CACHE: the hoisted cross-attention k/v
    layer_fuse: bool = False  # TCDIFF_LAYER_FUSE: K6, where the k/v are hoisted and no trj_dist is given
    layer_fuse_ff: bool = True  # TCDIFF_LAYER_FUSE_FF: K6 through the FF tail; off, K2 finishes the layer
    ca_block: Optional[bool] = None  # TCDIFF_PALLAS_XAB: K7 (None: on, off under int8 and per-op)
    int8: bool = False  # TCDIFF_INT8: int8 projections on the plain sites

    def __post_init__(self):
        if self.attention not in (0, 1, 2):
            raise ValueError(f"attention must be 0, 1 or 2, got {self.attention}")
        per_op = self.ln_rotary or self.layernorm or bool(self.attention)
        for name, flag in (("sa_block", "TCDIFF_PALLAS_SAB"), ("ff_block", "TCDIFF_PALLAS_FFB"),
                           ("ff_tail", "TCDIFF_PALLAS_FFT"), ("ca_block", "TCDIFF_PALLAS_XAB")):
            value = getattr(self, name)
            if value is None:
                object.__setattr__(self, name, not (self.int8 or (name == "ca_block" and per_op)))
            elif value and self.int8 and flag not in _WARNED_INT8_SHADOW:
                _WARNED_INT8_SHADOW.add(flag)
                warnings.warn(f"TCDIFF_INT8=1 with {flag}=1: the bf16 block kernel takes this site, so int8 "
                              f"only reaches the remaining projections.", stacklevel=3)

    @classmethod
    def per_op(cls, attention: int = 1, kv_cache: bool = True) -> "ServingKernels":
        """The block kernels off and the per-op kernels K8-K11 on."""
        return cls(sa_block=False, ff_block=False, layernorm=True, ln_matmul=True, ln_rotary=True,
                   attention=attention, kv_cache=kv_cache)

    @classmethod
    def from_env(cls, environ=None) -> "ServingKernels":
        """Read the JAX package's flags (TCDIFF_PALLAS_SAB=1, ...) from
        `environ` (os.environ by default); an unset flag keeps its default."""
        env = os.environ if environ is None else environ
        block = lambda name: None if env.get(name) is None else env[name] == "1"
        return cls(
            sa_block=block("TCDIFF_PALLAS_SAB"),
            ff_block=block("TCDIFF_PALLAS_FFB"),
            ff_tail=block("TCDIFF_PALLAS_FFT"),
            fuse_film=_env_flag(env, "TCDIFF_FUSE_FILM", False),
            layernorm=_env_flag(env, "TCDIFF_PALLAS_LN", False),
            ln_matmul=_env_flag(env, "TCDIFF_PALLAS_LNMM", False),
            ln_rotary=_env_flag(env, "TCDIFF_PALLAS_LNROT", False),
            attention=int(env.get("TCDIFF_PALLAS_ATTENTION", "0")),
            kv_cache=_env_flag(env, "TCDIFF_KV_CACHE", True),
            layer_fuse=_env_flag(env, "TCDIFF_LAYER_FUSE", False),
            layer_fuse_ff=_env_flag(env, "TCDIFF_LAYER_FUSE_FF", True),
            ca_block=block("TCDIFF_PALLAS_XAB"),
            int8=_env_flag(env, "TCDIFF_INT8", False),
        )


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Gaussian diffusion: schedule, sampler and the 4-term loss weights."""

    n_timestep: int = 1000
    schedule: str = "cosine"
    loss_type: str = "l2"
    clip_denoised: bool = True
    predict_epsilon: bool = False  # model predicts x0 directly
    guidance_weight: float = 2.0
    use_p2: bool = False
    cond_drop_prob: float = 0.25
    sampling_timesteps: int = 50  # DDIM steps
    ddim_eta: float = 1.0
    w_recon: float = 0.636
    w_velocity: float = 2.964
    w_fk: float = 0.646
    w_foot: float = 10.942
    footwork_frames: Tuple[int, int] = (75, 120)
    footwork_joints: Tuple[int, ...] = (1, 2, 3, 4, 5, 7, 8, 10, 11)
    footwork_blend_width: int = 10


@dataclasses.dataclass(frozen=True)
class TrajDecoderConfig:
    """Dance-Beat Navigator (DBN), the trajectory network (reference
    `TrajDecoder/model/traj_model.py:125-167`,
    `TrajDecoder/options/option_traj.py:3-70`); the trainer's fields are
    carried for the DBN trainer."""

    nfeats: int = 2  # global XY
    trans_layer: int = 6
    window_size: int = 100
    step: int = 25
    latent_dim: int = 64
    n_head: int = 4
    dropout: float = 0.1
    cond_feature_dim: int = 438
    # trainer
    total_iter: int = 800_000
    print_iter: int = 5000
    batch_size: int = 128
    lr: float = 2e-3
    gamma: float = 0.05
    lr_milestones: Tuple[int, ...] = (60_000,)
    weight_decay: float = 1e-6
    adam_betas: Tuple[float, float] = (0.5, 0.9)
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Diffusion trainer: the fields the train step and `TCDiff`'s loops
    read, the mesh's data- and tensor-parallel sizes (dp x tp the world
    size of the process group; dp=-1: the world over tp) and `remat`
    (recompute each decoder layer's forward in the backward instead of
    keeping its activations). The JAX package's scan knob has no
    counterpart here; its flag raises in `cli.args.check_ported`."""

    batch_size: int = 37
    learning_rate: float = 5e-5
    weight_decay: float = 0.02
    epochs: int = 10000
    save_interval: int = 50
    ema_interval: int = 1
    ema_beta: float = 0.9999
    seed: int = 0
    adan_betas: Tuple[float, float, float] = (0.02, 0.08, 0.01)
    adan_eps: float = 1e-8
    compute_dtype: str = "float32"  # the network's forward: "float32" or "bfloat16"
    dp: int = -1
    tp: int = 1
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where `TCDiff.load_datasets` reads the AIOZ tree and keeps its
    processed cache (reference `dataset/group_dataset.py:99-165`). The JAX
    package's frame rates, slice lengths and feature width are the data
    modules' own constants here (`DATA_FPS`, `create_dataset`)."""

    data_path: str = "./data/AIOZ_Dataset/"
    processed_data_dir: str = "./data/dataset_backups/"


@dataclasses.dataclass(frozen=True)
class TCDiffConfig:
    """Top-level bundle the CLI fills and `TCDiff` reads."""

    model: DanceDecoderConfig = dataclasses.field(default_factory=DanceDecoderConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    traj: TrajDecoderConfig = dataclasses.field(default_factory=TrajDecoderConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def with_dancers(self, n: int) -> "TCDiffConfig":
        return dataclasses.replace(self, model=dataclasses.replace(self.model, dancer_num=n))


DATA_FPS = 30  # motion frames a second (the JAX package's DataConfig.raw_fps)

# Channel layout of the 151-d motion representation:
# [contacts(4), root_pos(3), rot6d(24*6)]
N_JOINTS = 24
FOOT_JOINTS = (7, 8, 10, 11)  # lankle, rankle, ltoes, rtoes
