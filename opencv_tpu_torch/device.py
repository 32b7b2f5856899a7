"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextlib

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
