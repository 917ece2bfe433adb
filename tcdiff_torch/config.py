"""Configuration types and constants of the port.

A copy of the dataclasses and constants `tcdiff_tpu/config.py` defines for
the denoiser, the diffusion and the trainer (same defaults), so that the
port runs where JAX is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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
class TrainConfig:
    """Diffusion trainer: the fields the train step reads (the JAX
    package's mesh, remat and scan knobs have no counterpart here)."""

    batch_size: int = 37
    learning_rate: float = 5e-5
    weight_decay: float = 0.02
    ema_interval: int = 1
    ema_beta: float = 0.9999
    seed: int = 0
    adan_betas: Tuple[float, float, float] = (0.02, 0.08, 0.01)
    adan_eps: float = 1e-8


# Channel layout of the 151-d motion representation:
# [contacts(4), root_pos(3), rot6d(24*6)]
N_JOINTS = 24
FOOT_JOINTS = (7, 8, 10, 11)  # lankle, rankle, ltoes, rtoes
