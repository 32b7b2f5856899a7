"""Lane detection (port of examples/lane_detection.py, the analog of
samples/gpu/lane_detection.cpp): Gaussian blur -> Canny -> Hough segment
detector with the reference's parameters
(createHoughSegmentDetector(1.0, pi/180, 30, 200), lane_detection.cpp:244).

    python -m opencv_tpu_torch.examples.lane_detection [--cpu]

The synthetic road: two converging lane lines on noise, 240x320. Exits 0
when a segment lies along each lane.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import edges, hough

H, W = 240, 320
LANES = {"left": (80, 230, 150, 120), "right": (260, 230, 180, 120)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.lane_detection",
                                 description="Lane detection on a synthetic road.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap


def draw_line(img: np.ndarray, x0, y0, x1, y1, value: float = 220.0, thick: int = 2) -> np.ndarray:
    n = int(max(abs(x1 - x0), abs(y1 - y0)) * 2 + 1)
    t = np.linspace(0, 1, n)
    xs = np.round(x0 + t * (x1 - x0)).astype(int)
    ys = np.round(y0 + t * (y1 - y0)).astype(int)
    for d in range(thick):
        img[np.clip(ys, 0, img.shape[0] - 1), np.clip(xs + d, 0, img.shape[1] - 1)] = value
    return img


def road() -> np.ndarray:
    """The seeded road: uniform noise 20-60 and the two lanes, f32 [H, W]."""
    rng = np.random.default_rng(0)
    img = rng.uniform(20, 60, size=(H, W)).astype(np.float32)
    for lane in LANES.values():
        draw_line(img, *lane)
    return img


def has_segment_near(xyxy: np.ndarray, x0, y0, x1, y1, tol: float = 12) -> bool:
    """Do a segment's two ends lie within 2 tol px of the lane's ends,
    summed, in either order?"""
    p, q = np.array([x0, y0]), np.array([x1, y1])
    for s in xyxy:
        a, b = np.array([s[0], s[1]]), np.array([s[2], s[3]])
        if min(np.linalg.norm(a - p) + np.linalg.norm(b - q),
               np.linalg.norm(a - q) + np.linalg.norm(b - p)) < 2 * tol:
            return True
    return False


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    img = torch.from_numpy(road()).to(dev)
    # the reference smooths the frame before edge detection: raw sensor
    # noise would dominate the gradients
    smooth = imgproc.gaussian_blur(img, 5, 1.5)
    e = edges.canny(smooth, 60, 120)
    segs = hough.hough_segments(e, threshold=30.0, min_line_length=60, max_line_gap=5, max_lines=16)
    xyxy = segs.xyxy.cpu().numpy()[segs.valid.cpu().numpy()]
    edge_px = int(e.sum())
    print(f"edges: {edge_px} px, segments found: {len(xyxy)}")
    for s in xyxy[:6]:
        print("  segment", np.round(s, 1))
    found = {name: has_segment_near(xyxy, *lane) for name, lane in LANES.items()}
    print(f"left lane: {'FOUND' if found['left'] else 'missed'}  "
          f"right lane: {'FOUND' if found['right'] else 'missed'}")
    return dict(edge_px=edge_px, segments=len(xyxy), segment_xyxy=xyxy.tolist(), left=found["left"],
                right=found["right"], ok=bool(found["left"] and found["right"]))


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
