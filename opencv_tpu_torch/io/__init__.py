"""Image and video I/O (port of opencv_tpu/io/): host numpy readers and
writers; JPEG decoding through the port's own baseline decoder
(`_jpeg.py`) where the file allows it."""

from opencv_tpu_torch.io import image, kitti, video  # noqa: F401
from opencv_tpu_torch.io.video import VideoCapture, VideoWriter  # noqa: F401
