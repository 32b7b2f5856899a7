"""Bundle adjustment, Levenberg-Marquardt, minimizers and the pose graph."""

from opencv_tpu_torch.optim import (  # noqa: F401
    ba,
    levmarq,
    minimize,
    pose_graph,
)
