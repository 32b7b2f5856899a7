"""The monocular visual-odometry engine."""

from opencv_tpu_torch.slam import (  # noqa: F401
    vo,
)
