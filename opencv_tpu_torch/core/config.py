"""Algorithm configuration dataclasses (analog of the reference's
Algorithm ctor params + getter/setter pairs, e.g. ORB::create defaults at
features2d/include/opencv2/features2d.hpp:333).

All configs are frozen dataclasses of *static* values, copied field for
field from opencv_tpu/core/config.py so a config of either package can be
rebuilt from `dataclasses.asdict` of the other (see convert.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FASTConfig:
    """cv::FastFeatureDetector params (features2d/src/fast.cpp:492)."""

    threshold: float = 20.0
    nonmax_suppression: bool = True
    arc_length: int = 9  # TYPE_9_16


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """cv::ORB::create defaults (features2d.hpp:333)."""

    n_features: int = 500
    scale_factor: float = 1.2
    n_levels: int = 8
    edge_threshold: int = 31
    first_level: int = 0
    wta_k: int = 2
    patch_size: int = 31
    fast_threshold: float = 20.0
    harris_block: int = 7
    # capacity of per-level candidate pool before top-K culling
    max_candidates_per_level: int = 4096


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """SparsePyrLKOpticalFlow defaults (video/src/lkpyramid.cpp:799-838):
    win 21x21, 3 levels, 30 iters, eps 0.01, minEig 1e-4."""

    win_size: int = 21
    n_levels: int = 3
    max_iters: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 1e-4


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC (the GPU pattern of
    cudalegacy/src/calib3d.cpp:211, not the sequential CPU loop)."""

    n_hypotheses: int = 1024
    threshold: float = 1.0  # model-specific units (px or normalized)
    confidence: float = 0.999
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    ratio: float = 0.8  # Lowe ratio for knn-2 matching
    cross_check: bool = True
    max_distance: float = 256.0
