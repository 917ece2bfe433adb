"""tcdiff_torch — the PyTorch/CUDA port of tcdiff_tpu for NVIDIA Hopper.

Layout mirrors `tcdiff_tpu/`: `models/` (rotary, DanceDecoder),
`diffusion/` (schedules, DDIM sampler, train loss), `geometry/`
(rotations, SMPL FK), `optim/` (Adan, EMA), `train/` (the train step),
`ops/` (the block kernels, their plain versions and the nvcc build),
`csrc/` (CUDA sources) and `interop/` (flax weights in). Configuration
types are in `config.py`.
"""

from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TrainConfig  # noqa: F401
