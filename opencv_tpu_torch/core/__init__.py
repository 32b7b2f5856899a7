"""Core types, configs, image operators and pyramids."""

from opencv_tpu_torch.core import (  # noqa: F401
    config,
    imgproc,
    pyramid,
    types,
)
