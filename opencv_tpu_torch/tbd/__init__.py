from opencv_tpu_torch.tbd import assignment, detection_based, tracker  # noqa: F401
from opencv_tpu_torch.tbd.detection_based import DetectionBasedTracker  # noqa: F401
from opencv_tpu_torch.tbd.tracker import MotMetrics, TbdConfig, Track, Tracker  # noqa: F401
