"""Kalman filter: batched predict/correct (port of opencv_tpu/ops/kalman.py).

The analog of cv::KalmanFilter: the state is a pair of tensors with any
leading batch shape, so a tracker holding N targets updates all of them
in one call. Plain functions on tensors; the device is the state's.

The products and the small `linalg.solve` run in true f32: TF32 is
turned off around them (on the card a matmul would otherwise round its
operands to 10 mantissa bits under a caller's global switch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.device import no_tf32, resolve_device


class KalmanState(NamedTuple):
    x: torch.Tensor  # [..., S] state estimate
    P: torch.Tensor  # [..., S, S] covariance


def predict(state: KalmanState, F: torch.Tensor, Q: torch.Tensor) -> KalmanState:
    """x <- F x;  P <- F P F^T + Q."""
    with no_tf32():
        x = torch.einsum("ij,...j->...i", F, state.x)
        P = torch.einsum("ij,...jk,lk->...il", F, state.P, F) + Q
    return KalmanState(x=x, P=P)


def correct(state: KalmanState, H: torch.Tensor, R: torch.Tensor, z: torch.Tensor) -> KalmanState:
    """Measurement update with z [..., M]."""
    with no_tf32():
        S = torch.einsum("ij,...jk,lk->...il", H, state.P, H) + R
        PHt = torch.einsum("...ij,kj->...ik", state.P, H)
        K = torch.linalg.solve(S, PHt.transpose(-1, -2)).transpose(-1, -2)  # [..., S, M]
        innov = z - torch.einsum("ij,...j->...i", H, state.x)
        x = state.x + torch.einsum("...ij,...j->...i", K, innov)
        eye = torch.eye(state.P.shape[-1], dtype=state.P.dtype, device=state.P.device)
        KH = torch.einsum("...ij,jk->...ik", K, H)
        P = torch.einsum("...ij,...jk->...ik", eye - KH, state.P)
    return KalmanState(x=x, P=P)


def constant_velocity_model(
    dim: int, dt: float = 1.0, process_noise: float = 1e-2,
    measurement_noise: float = 1e-1, init_var: float = 1.0, device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, H, Q, R, P0) f32 for a [pos(dim), vel(dim)] state measuring pos
    (the TBD tracker's motion model, tbd.hpp:96-121). On the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    eye = torch.eye(dim, device=dev)
    zero = torch.zeros((dim, dim), device=dev)
    F = torch.cat([torch.cat([eye, dt * eye], 1), torch.cat([zero, eye], 1)], 0)
    H = torch.cat([eye, zero], 1)
    Q = process_noise * torch.eye(2 * dim, device=dev)
    R = measurement_noise * torch.eye(dim, device=dev)
    P0 = init_var * torch.eye(2 * dim, device=dev)
    return F, H, Q, R, P0
