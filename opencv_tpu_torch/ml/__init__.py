"""Machine learning (port of opencv_tpu/ml/): the classifiers, clustering,
trees and boosting, and the cascade trainer."""

from opencv_tpu_torch.ml import classifiers, clustering, traincascade, trees  # noqa: F401
