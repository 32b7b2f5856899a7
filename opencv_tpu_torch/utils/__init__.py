"""Utilities (port of opencv_tpu/utils/): trajectory evaluation, the
numeric guards, drawing and plots, leveled logging, state persistence,
region profiling and the real-imagery sequence renderer."""

from opencv_tpu_torch.utils import evaluate, guard, viz  # noqa: F401
