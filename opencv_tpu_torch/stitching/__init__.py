from opencv_tpu_torch.stitching import blend, stitcher, warpers  # noqa: F401
