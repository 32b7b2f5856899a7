"""Hand-written CUDA kernels for Hopper (the counterpart of ops/pallas/).

Each wrapper takes its kernel's plain PyTorch version only for CPU
tensors; for CUDA tensors it launches the kernel and raises on any launch
error. `launch_counts` counts kernel launches per wrapper (plain-version
calls are not counted), so a run can show that it went through them.
"""

launch_counts: dict[str, int] = {
    "fast_corners": 0, "fast_score": 0, "knn2_hamming": 0, "lk_sample": 0, "lk_sample_clamp": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
