"""DNN inference (port of opencv_tpu/dnn/): layers, the Net container and
the ONNX, Darknet, Caffe and TensorFlow importers, with the JAX
package's exports."""

from opencv_tpu_torch.dnn import (  # noqa: F401
    caffe_importer,
    darknet_importer,
    layers,
    net,
    onnx_importer,
    proto,
    tf_importer,
)
from opencv_tpu_torch.dnn.caffe_importer import load_caffe  # noqa: F401
from opencv_tpu_torch.dnn.darknet_importer import load_darknet  # noqa: F401
from opencv_tpu_torch.dnn.net import Net  # noqa: F401
from opencv_tpu_torch.dnn.onnx_importer import load_onnx  # noqa: F401
from opencv_tpu_torch.dnn.tf_importer import load_tf  # noqa: F401
