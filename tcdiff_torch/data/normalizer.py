"""Min-max normalization of motion channels, on tensors on one device.

The port's form of `tcdiff_tpu/data/normalizer.py`, behavior-compatible
with the reference's `Normalizer`/`MinMaxScaler` pair
(`dataset/preprocess.py:28-43`, `dataset/scaler.py:19-83`):

  * fit on the flattened (N*S, C) feature matrix, per-channel min/max;
  * near-constant channels (range under 10 float eps) get scale 1
    (`scaler.py:4-16`);
  * normalize: x * scale + min, clipped to [-1, 1];
  * unnormalize: clip to [-1, 1] first, then invert; an input with fewer
    channels than the fit data uses the TRAILING channels of the stats
    (`scaler.py:80-83`), which the reference uses to unnormalize the 147
    non-contact channels with a 151-channel scaler.

Transforms never mutate their input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Normalizer:
    scale: torch.Tensor  # (C,)
    offset: torch.Tensor  # (C,), the reference's `min_`

    feature_range = (-1.0, 1.0)

    @property
    def device(self) -> torch.device:
        return self.scale.device

    @classmethod
    def fit(cls, data, device="cuda") -> "Normalizer":
        """data: (..., C), a tensor or an array; the stats are taken over all
        leading dims, in float32, on `device`."""
        flat = torch.as_tensor(data, dtype=torch.float32, device=device).reshape(-1, data.shape[-1])
        data_min = flat.min(dim=0).values
        data_range = flat.max(dim=0).values - data_min
        eps = 10 * torch.finfo(flat.dtype).eps
        safe_range = torch.where(data_range < eps, torch.ones_like(data_range), data_range)
        lo, hi = cls.feature_range
        scale = (hi - lo) / safe_range
        return cls(scale=scale, offset=lo - data_min * scale)

    @classmethod
    def identity(cls, channels: int, device="cuda") -> "Normalizer":
        return cls(scale=torch.ones(channels, device=device), offset=torch.zeros(channels, device=device))

    @classmethod
    def from_torch_state(cls, scale_, min_, device="cuda") -> "Normalizer":
        """From a reference checkpoint's pickled MinMaxScaler attributes (the
        reference stores the whole Normalizer object in its .pt file,
        `TCDiff.py:74`)."""
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
        return cls(scale=as_t(scale_), offset=as_t(min_))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.feature_range
        return (x * self.scale + self.offset).clamp(lo, hi)

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse transform; fewer channels than the fit data use the
        trailing channels of the stats."""
        lo, hi = self.feature_range
        c = x.shape[-1]
        return (x.clamp(lo, hi) - self.offset[-c:]) / self.scale[-c:]

    def to_numpy(self) -> dict:
        return {"scale": self.scale.cpu().numpy(), "offset": self.offset.cpu().numpy()}
