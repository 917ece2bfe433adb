"""Constant-velocity Kalman filter over every (batch, dancer) trajectory at
once, on the trajectories' device.

The port of `tcdiff_tpu/trajdecoder/kalman.py:19-100`, the reference's
filterpy filter (`TrajDecoder/utils/utils_model.py:10-74`): state
[x, y, vx, vy], F with dt coupling, H observing the positions, P0 = 10 I,
x0 = [first xy, 0, 0], R = 0.1^2 I and Q = 1e-2 I (the reference sets Q to
the std, not its square, `utils_model.py:51-55`), the Joseph-form update.
One step is a dozen small batched ops over (N, 4) states; the time loop
runs on the host. Like the DBN, the filter computes in f32 whatever the
caller's TF32 flags (`model.f32_math`).

The filter is causal, and a chunk runs the same step on the carried state,
so filtering in chunks (`kalman_filter_chunk`) gives the batch result
(`kalman_smooth_batch`) bit for bit.
"""

from __future__ import annotations

import torch

from tcdiff_torch.trajdecoder.model import f32_math


def _matrices(dt, q_std, r_std, dtype, device):
    F = torch.tensor([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=dtype, device=device)
    H = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0]], dtype=dtype, device=device)
    Q = torch.eye(4, dtype=dtype, device=device) * q_std  # std, not variance: the reference's quirk
    R = torch.eye(2, dtype=dtype, device=device) * r_std**2
    return F, H, Q, R


def _inv2(S: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of 2x2 matrices (N, 2, 2), by the adjugate: no
    solver call, and no host synchronisation for an error check."""
    a, b, c, d = S[:, 0, 0], S[:, 0, 1], S[:, 1, 0], S[:, 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / (a * d - b * c)[:, None, None]


def _kalman_scan(xy: torch.Tensor, x: torch.Tensor, P: torch.Tensor, dt=1.0, process_noise_std=1e-2,
                 measurement_noise_std=1e-1):
    """Filter xy (N, T, 2) from the states x (N, 4), P (N, 4, 4).
    Returns (filtered positions (N, T, 2), (x_T, P_T))."""
    F, H, Q, R = _matrices(dt, process_noise_std, measurement_noise_std, xy.dtype, xy.device)
    eye = torch.eye(4, dtype=xy.dtype, device=xy.device)
    out = []
    for t in range(xy.shape[1]):
        x = x @ F.T  # predict
        P = F @ P @ F.T + Q
        S = H @ P @ H.T + R  # update
        K = P @ H.T @ _inv2(S)
        x = x + (K @ (xy[:, t] - x @ H.T)[..., None])[..., 0]
        IKH = eye - K @ H  # filterpy: P = (I - KH) P (I - KH)^T + K R K^T
        P = IKH @ P @ IKH.transpose(1, 2) + K @ R @ K.transpose(1, 2)
        out.append(x[:, :2])
    return torch.stack(out, dim=1), (x, P)


@torch.no_grad()
def kalman_filter_chunk(xy_chunk: torch.Tensor, state=None, dt=1.0, process_noise_std=1e-2,
                        measurement_noise_std=1e-1):
    """Incremental filtering for streaming: an (N, T, 2) chunk and the
    carried state -> (filtered (N, T, 2), state). state=None starts from the
    chunk's first frame, as the batch filter does."""
    if state is None:  # x0 = [first xy, 0, 0], P0 = 10 I
        first = xy_chunk[:, 0]
        state = (torch.cat([first, torch.zeros_like(first)], dim=-1),
                 (torch.eye(4, dtype=first.dtype, device=first.device) * 10.0).expand(first.shape[0], 4, 4))
    with f32_math():
        return _kalman_scan(xy_chunk, *state, dt, process_noise_std, measurement_noise_std)


@torch.no_grad()
def kalman_smooth_batch(xy_batch: torch.Tensor, dt=1.0, process_noise_std=1e-2, measurement_noise_std=1e-1):
    """(B, dn, T, 2) -> the same shape, filtered."""
    b, dn, t, _ = xy_batch.shape
    out, _ = kalman_filter_chunk(xy_batch.reshape(b * dn, t, 2), None, dt, process_noise_std,
                                 measurement_noise_std)
    return out.reshape(b, dn, t, 2)
