"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> "cuda". A CUDA device without a card raises: the port never
    falls back to the CPU on its own; callers ask for it explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opencv_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def no_tf32():
    """True f32 matmuls and convolutions inside the block, whatever the
    caller's global switches say (the JAX code's exact f32 on the CPU and
    Precision.HIGHEST); the switches are restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / f32(d) as a true division on every device. CUDA divides a tensor
    by a Python float as a multiply by its reciprocal, which rounds
    otherwise than the CPU's division and XLA's; a divisor on the device
    takes the division kernel."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def on_device(x, device=None) -> torch.Tensor:
    """`x` as a tensor: a tensor stays where it is unless `device` names
    another device; anything else goes to `resolve_device(device)` (the
    card unless the caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
