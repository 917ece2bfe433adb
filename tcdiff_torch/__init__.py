"""tcdiff_torch — the PyTorch/CUDA port of tcdiff_tpu for NVIDIA Hopper.

Layout mirrors `tcdiff_tpu/`: `models/` (rotary, DanceDecoder),
`diffusion/` (schedules, the DDIM and DDPM samplers, inpainting masks,
train loss), `geometry/` (rotations, SMPL FK), `optim/` (Adan, EMA),
`train/` (the train step, the orchestrator and its `TCDiff` class),
`data/` and `trajdecoder/` (the dataset and the DBN), `eval/` (the quality
metrics), `viz/` (post-processing and renders), `export/` (per-dancer
pkls, BVH, FBX), `cli/` (`train`, `train_traj`), `ops/` (the kernels,
their plain versions and the nvcc build), `csrc/` (CUDA sources) and
`interop/` (flax weights in).
Configuration types, and `ServingKernels` (which kernels serve), are in
`config.py`.
"""

from tcdiff_torch.config import (  # noqa: F401
    DanceDecoderConfig, DataConfig, DiffusionConfig, ServingKernels, TCDiffConfig, TrainConfig, TrajDecoderConfig,
)
