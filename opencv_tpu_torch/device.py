"""Device resolution for the port's entry points."""

from __future__ import annotations

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
