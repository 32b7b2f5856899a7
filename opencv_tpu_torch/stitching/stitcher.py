"""Two-image panorama stitcher (port of opencv_tpu/stitching/stitcher.py;
reference stitching/src/stitcher.cpp:122-148 estimateTransform ->
composePanorama): ORB on both images (kernel K1 on the card), the dense
2-NN matcher, a homography RANSAC, both images warped onto a common
canvas and feather-blended.

The JAX function keys its RANSAC by `PRNGKey(seed)`, which torch cannot
replay: here a CPU generator seeded with `seed` draws the subsets (the
same on the card as on the CPU), or the caller injects them.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.config import MatchConfig, ORBConfig, RansacConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry import homography as hom
from opencv_tpu_torch.ops import matching, orb
from opencv_tpu_torch.stitching.blend import feather_blend

PAIR_RANSAC = RansacConfig(n_hypotheses=1024, threshold=3.0)


def pair_homography(t0: torch.Tensor, t1: torch.Tensor, n_features: int, gen, subsets=None):
    """ORB both images, 2-NN match, RANSAC: (H10 f64 [3, 3] with x0 ~ H10
    x1, the RANSAC result). One host read of the model."""
    cfg = ORBConfig(n_features=n_features, n_levels=4)
    kp0, d0 = orb.detect_and_compute(t0, cfg)
    kp1, d1 = orb.detect_and_compute(t1, cfg)
    m = matching.knn_match(d0, d1, query_valid=kp0.valid, train_valid=kp1.valid,
                           config=MatchConfig())
    res = hom.find_homography_ransac(
        gen, kp1.xy[m.train_idx], kp0.xy[m.query_idx],  # maps img1 -> img0 coords
        valid=m.valid, cfg=PAIR_RANSAC, subsets=subsets)
    return res.model.cpu().double().numpy(), res


def stitch_pair(img0, img1, seed: int = 0, n_features: int = 1000, blend: str = "feather",
                subsets: torch.Tensor | None = None, device=None) -> np.ndarray:
    """Stitch img1 onto img0's frame; returns the composite canvas (numpy
    f32). RANSAC draws its 1024 subsets from a generator seeded with
    `seed` unless `subsets` [1024, 4] are given. Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    t0 = torch.as_tensor(img0, device=dev).to(torch.float32)
    t1 = torch.as_tensor(img1, device=dev).to(torch.float32)
    gen = torch.Generator()
    gen.manual_seed(seed)
    H10, _ = pair_homography(t0, t1, n_features, gen, subsets)

    # canvas bounds: img0 plus img1's warped corners
    h0, w0 = t0.shape
    h1, w1 = t1.shape
    corners = np.array([[0, 0, 1], [w1, 0, 1], [0, h1, 1], [w1, h1, 1]], np.float64).T
    wc = H10 @ corners
    wc = wc[:2] / wc[2]
    x_min = min(0.0, wc[0].min())
    y_min = min(0.0, wc[1].min())
    x_max = max(float(w0), wc[0].max())
    y_max = max(float(h0), wc[1].max())
    out_w = int(np.ceil(x_max - x_min))
    out_h = int(np.ceil(y_max - y_min))
    T = np.array([[1, 0, -x_min], [0, 1, -y_min], [0, 0, 1]], np.float64)

    # warp_perspective takes the output->input map
    M0 = np.linalg.inv(T).astype(np.float32)
    M1 = np.linalg.inv(T @ H10).astype(np.float32)
    w0_img = imgproc.warp_perspective(t0, M0, out_h, out_w)
    w1_img = imgproc.warp_perspective(t1, M1, out_h, out_w)
    m0 = imgproc.warp_perspective(torch.ones_like(t0), M0, out_h, out_w) > 0.5
    m1 = imgproc.warp_perspective(torch.ones_like(t1), M1, out_h, out_w) > 0.5
    if blend == "feather":
        out = feather_blend([w0_img, w1_img], [m0, m1])
    else:
        out = torch.where(m0, w0_img, w1_img)
    return out.cpu().numpy()
