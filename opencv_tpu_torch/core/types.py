"""Core data records: structure-of-arrays, fixed capacity, validity masks.

Port of opencv_tpu/core/types.py. The fixed-capacity + `valid` mask
convention is kept as it is: every consumer is mask-aware, and the
records compare field for field with the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from opencv_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class KeyPoints:
    """Fixed-capacity keypoint set (SoA analog of vector<cv::KeyPoint>).

    xy [N,2] f32 (level-0 coords), response [N] f32, angle [N] f32
    (radians), level [N] i32, size [N] f32, valid [N] bool.
    """

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    level: torch.Tensor
    size: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def empty(n: int, device=None) -> "KeyPoints":
        return KeyPoints(
            xy=torch.zeros((n, 2), dtype=torch.float32, device=device),
            response=torch.full((n,), -float("inf"), dtype=torch.float32, device=device),
            angle=torch.zeros((n,), dtype=torch.float32, device=device),
            level=torch.zeros((n,), dtype=torch.int32, device=device),
            size=torch.zeros((n,), dtype=torch.float32, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    @staticmethod
    def concatenate(parts: list["KeyPoints"]) -> "KeyPoints":
        return KeyPoints(*[
            torch.cat([getattr(p, f.name) for p in parts], dim=0)
            for f in dataclasses.fields(KeyPoints)
        ])


@dataclasses.dataclass(frozen=True)
class Matches:
    """Fixed-capacity match set: one row per query descriptor.
    query_idx [N] i64, train_idx [N] i64, distance [N] f32, valid [N] bool."""

    query_idx: torch.Tensor
    train_idx: torch.Tensor
    distance: torch.Tensor
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum()


@dataclasses.dataclass(frozen=True)
class Pose:
    """Rigid transform world->camera: x_cam = R @ x_world + t."""

    R: torch.Tensor  # [3,3]
    t: torch.Tensor  # [3]

    @staticmethod
    def identity(device=None) -> "Pose":
        return Pose(
            R=torch.eye(3, dtype=torch.float32, device=device),
            t=torch.zeros(3, dtype=torch.float32, device=device),
        )

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: apply `other` first, then `self`."""
        return Pose(R=self.R @ other.R, t=self.R @ other.t + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.T
        return Pose(R=Rt, t=-Rt @ self.t)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return pts @ self.R.T + self.t


def masked_top_k(
    values: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of `values` restricted to `valid`; returns (indices[k], keep[k]).

    A stable descending sort, not `torch.topk`: on tied values (integer
    FAST scores) `lax.top_k` keeps the lower index first, and only a
    stable sort reproduces that set and order.
    """
    masked = torch.where(valid, values, torch.full_like(values, -float("inf")))
    top_vals, top_idx = torch.sort(masked, descending=True, stable=True)
    return top_idx[:k], torch.isfinite(top_vals[:k])


def camera_matrix(fx: float, fy: float, cx: float, cy: float, device=None) -> torch.Tensor:
    """3x3 intrinsic matrix K (f32), on `device` (the card unless the
    caller asks for the CPU)."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                        device=resolve_device(device))


def take_keypoints(kp: KeyPoints, idx: torch.Tensor, valid: torch.Tensor | None = None) -> KeyPoints:
    """Gather keypoints by index, intersecting validity."""
    v = kp.valid[idx]
    if valid is not None:
        v = v & valid
    return KeyPoints(xy=kp.xy[idx], response=kp.response[idx], angle=kp.angle[idx],
                     level=kp.level[idx], size=kp.size[idx], valid=v)


def pad_to(x: torch.Tensor, n: int, axis: int = 0, fill=0) -> torch.Tensor:
    """Pad `axis` to length n with `fill`, or cut it to n."""
    cur = x.shape[axis]
    if cur >= n:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - cur
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis)
