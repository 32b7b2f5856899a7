"""opencv_tpu_torch — the PyTorch/CUDA port of opencv_tpu for NVIDIA Hopper.

A second package beside the JAX reference (`opencv_tpu/`): the same
modules at the same relative paths, written in PyTorch, with the Pallas
kernels of the JAX package replaced by hand-written CUDA kernels for
sm_90a (`csrc/`, bound with ctypes in `ops/cuda/`).

Conventions:
- plain functions on tensors; the device is taken from the inputs;
- entry points that create tensors (the VO engine, `convert.load_map`)
  run on the card unless the caller passes `device="cpu"`;
- packed 256-bit descriptors are int32 [N, 8] tensors holding the bit
  pattern of the JAX package's uint32 words (`.view(np.uint32)` on the
  numpy side recovers them);
- nothing here touches a device at import time.
"""

__version__ = "0.1.0"

from opencv_tpu_torch.core.types import KeyPoints, Matches  # noqa: F401
