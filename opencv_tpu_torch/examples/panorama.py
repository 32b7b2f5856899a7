"""Multi-image panorama stitching (port of examples/panorama.py, the analog
of the reference's samples/cpp/stitching.cpp driving cv::Stitcher).

    python -m opencv_tpu_torch.examples.panorama [--cpu] [--out panorama.png]

Renders three pure-rotation views (160x200, focal 200, yaws -0.45, 0 and
0.45 rad) of a seeded texture, estimates the focal and the rotations
(autocalibration, maximum spanning tree, ray bundle adjustment; ORB with
700 features: FAST kernel K1 on every view) and composes a seam-blended
spherical panorama into `--out`. The RANSACs draw from the port's own
generator (seed 1), not from JAX's PRNG. Exits 0, as the JAX example,
when the estimate is finite and its tree spans the views.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry.rotation import rodrigues
from opencv_tpu_torch.io.image import imwrite
from opencv_tpu_torch.stitching import global_stitch as gs

F, H, W = 200.0, 160, 200
YAWS = (-0.45, 0.0, 0.45)
N_FEATURES = 700


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.panorama",
                                 description="Three-view panorama of a synthetic scene.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--out", default="panorama.png")
    return ap


def render_views(dev) -> list[torch.Tensor]:
    """The three views, f32 [H, W] on `dev`: a 90x90 uniform(30, 225)
    texture (seed 3) resized to 720x720 and seen through K R^-1 for each
    yaw, with the texture spanning +-1.8 on the z = 1 plane."""
    rng = np.random.default_rng(3)
    ts, span = 720, 1.8
    tex = torch.from_numpy(rng.uniform(30, 225, (ts // 8, ts // 8)).astype(np.float32)).to(dev)
    tex = imgproc.resize_bilinear(tex, ts, ts)
    S = np.array([[ts / (2 * span), 0, ts / 2], [0, ts / (2 * span), ts / 2], [0, 0, 1]])
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    views = []
    for yaw in YAWS:
        R = rodrigues(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)).numpy()
        M = S @ np.linalg.inv(K @ R)
        views.append(imgproc.warp_perspective(tex, M.astype(np.float32), H, W))
    return views


def main(argv=None) -> dict:
    """Estimate, stitch and write the panorama; besides the printed
    figures, the estimated rotations."""
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    views = render_views(dev)
    R, f, diag = gs.estimate_panorama(views, n_features=N_FEATURES, seed=1, device=dev)
    print(f"estimated focal: {f:.1f} (true {F}); "
          f"{len(diag['edges'])} confident pairs, tree {diag['tree']}")
    pano = gs.stitch_panorama(views, n_features=N_FEATURES, seed=1, blend_bands=2, device=dev)
    imwrite(args.out, pano)
    print(f"panorama {pano.shape[1]}x{pano.shape[0]} -> {args.out}")
    ok = bool(np.isfinite(f) and len(diag["tree"]) == len(views) - 1)
    return dict(focal=float(f), pairs=len(diag["edges"]), tree=[tuple(map(int, e)) for e in diag["tree"]],
                rotations=np.asarray(R).tolist(), size=[int(pano.shape[1]), int(pano.shape[0])],
                out=args.out, ok=ok)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
