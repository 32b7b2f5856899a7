"""Hand-written CUDA kernels for Hopper (the counterpart of ops/pallas/).

Each wrapper takes its kernel's plain PyTorch version only for CPU
tensors; for CUDA tensors it launches the kernel and raises on any launch
error. `launch_counts` counts kernel launches per wrapper (plain-version
calls are not counted), so a run can show that it went through them.
"""

import contextlib

import torch

launch_counts: dict[str, int] = {
    "fast_corners": 0, "fast_score": 0, "knn2_hamming": 0, "lk_sample": 0, "lk_sample_clamp": 0,
    "schur_cg_full": 0, "schur_cg_hz": 0, "schur_cg_back": 0, "schur_cg_g": 0, "schur_cg_update": 0,
    "normal_eq_smem": 0, "normal_eq_global": 0, "normal_eq_ordered": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def on_device(device: torch.device):
    """A context in which `device` is the current CUDA device, for a launch
    through a C interface that reads it: none where it is current already
    (`torch.cuda.device` costs ~9 us of host a call, three times in each of
    the Schur CG's iterations)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
