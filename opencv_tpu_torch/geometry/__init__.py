"""Multiple-view geometry: RANSAC estimators, PnP, calibration."""

from opencv_tpu_torch.geometry import (  # noqa: F401
    affine2d,
    calibration,
    epipolar,
    homography,
    ippe,
    pnp,
    ransac,
    rotation,
)
