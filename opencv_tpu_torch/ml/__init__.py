"""Machine learning (port of opencv_tpu/ml/): the cascade trainer so far;
the classifiers, clustering and trees are not ported yet."""

from opencv_tpu_torch.ml import traincascade  # noqa: F401
