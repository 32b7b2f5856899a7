"""Calibration application (port of examples/calibration_app.py, the
analog of the reference's apps/interactive-calibration tool, headless).

    python -m opencv_tpu_torch.examples.calibration_app [--cpu] [--views N] [--noise PX]

Renders a 7x5 chessboard at seeded poses into 480x640 views, finds the
corner grid in each image, calibrates, reports each view's reprojection
error, drops the worst view and calibrates again: the interactive tool's
frame filter (apps/interactive-calibration/calibController.cpp) without
the GUI. Exits 0 when the better calibration has RMS < 0.8 px and fx, fy
within 3 % of the truth.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry import calibration
from opencv_tpu_torch.geometry.rotation import rodrigues
from opencv_tpu_torch.ops.chessboard import find_chessboard_corners

COLS, ROWS = 7, 5
SQ = 40
H, W = 480, 640
F = 520.0
K_GT = np.array([[F, 0, W / 2 + 6], [0, F * 1.01, H / 2 - 4], [0, 0, 1]])
SQUARE_WORLD = 0.1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.calibration_app",
                                 description="Headless chessboard calibration.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.0, help="extra gaussian pixel noise on the images")
    return ap


def board_image() -> tuple[np.ndarray, int, int]:
    """The board's picture (squares of SQ px, dark 30 on light 210, a
    margin of one square) and its width and height in px."""
    bw, bh = (COLS + 1) * SQ, (ROWS + 1) * SQ
    board = np.full((bh + 2 * SQ, bw + 2 * SQ), 210.0, np.float32)
    for i in range(ROWS + 1):
        for j in range(COLS + 1):
            if (i + j) % 2 == 0:
                board[SQ * (i + 1):SQ * (i + 2), SQ * (j + 1):SQ * (j + 2)] = 30.0
    return board, bw, bh


def object_points() -> np.ndarray:
    """The inner corners on the board plane, f32 [ROWS * COLS, 3] (m)."""
    obj = np.zeros((ROWS * COLS, 3), np.float32)
    jj, ii = np.meshgrid(np.arange(COLS), np.arange(ROWS))
    obj[:, 0] = jj.reshape(-1) * SQUARE_WORLD
    obj[:, 1] = ii.reshape(-1) * SQUARE_WORLD
    return obj


def render_view(board: torch.Tensor, bw: int, bh: int, rvec: np.ndarray, tvec: np.ndarray) -> torch.Tensor:
    """The board seen by K_GT from pose (rvec, tvec): warp_perspective of
    its picture on the picture's device, f32 [H, W]."""
    R = rodrigues(torch.as_tensor(rvec, dtype=torch.float32)).numpy().astype(np.float64)
    s = SQUARE_WORLD / SQ
    T = np.array([[s, 0, -(bw / 2 + SQ) * s], [0, s, -(bh / 2 + SQ) * s], [0, 0, 1]])
    hom = K_GT @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ T
    return imgproc.warp_perspective(board, np.linalg.inv(hom).astype(np.float32), H, W)


def views(n: int, noise: float, dev) -> list[torch.Tensor]:
    """The n seeded views (poses from default_rng(0), then the noise when
    `noise` > 0, from the same generator), clipped to [0, 255], on `dev`."""
    rng = np.random.default_rng(0)
    board, bw, bh = board_image()
    board_t = torch.from_numpy(board).to(dev)
    out = []
    for _ in range(n):
        rvec = rng.uniform(-0.35, 0.35, 3).astype(np.float32)
        tvec = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(2.1, 2.9)])
        img = render_view(board_t, bw, bh, rvec, tvec)
        if noise > 0:
            noisy = img.cpu().numpy() + rng.normal(0, noise, img.shape)
            img = torch.from_numpy(np.clip(noisy, 0, 255).astype(np.float32)).to(dev)
        out.append(img.clamp(0.0, 255.0))
    return out


def _k_figures(res) -> dict:
    return dict(rms=float(res.rms), fx=float(res.K[0, 0]), fy=float(res.K[1, 1]),
                cx=float(res.K[0, 2]), cy=float(res.K[1, 2]))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    obj = object_points()
    img_pts, found = [], []
    for v, img in enumerate(views(args.views, args.noise, dev)):
        corners = find_chessboard_corners(img, (COLS, ROWS), device=dev)
        found.append(corners is not None)
        if corners is None:
            print(f"view {v}: board NOT found — skipped")
            continue
        img_pts.append(np.asarray(corners))
        print(f"view {v}: grid found")
    out = dict(views=args.views, found=found)
    if len(img_pts) < 4:
        print("not enough views")
        return dict(out, ok=False)

    def run_calib(pts):
        return calibration.calibrate_camera(np.stack([obj] * len(pts)), np.stack(pts), device=dev)

    res = run_calib(img_pts)
    print(f"\ncalibration over {len(img_pts)} views: RMS = {res.rms:.3f} px")
    print(f"  fx {res.K[0,0]:.1f} (gt {K_GT[0,0]:.1f})  "
          f"fy {res.K[1,1]:.1f} (gt {K_GT[1,1]:.1f})")
    print(f"  cx {res.K[0,2]:.1f} (gt {K_GT[0,2]:.1f})  "
          f"cy {res.K[1,2]:.1f} (gt {K_GT[1,2]:.1f})")

    # interactive-calibration's frame filter: drop the worst-residual view
    # and re-calibrate
    k4 = torch.tensor([res.K[0, 0], res.K[1, 1], res.K[0, 2], res.K[1, 2]], device=dev)
    uv = calibration.project_points_full(
        torch.from_numpy(res.rvecs).to(dev), torch.from_numpy(res.tvecs).to(dev), k4,
        torch.from_numpy(res.dist).to(dev), torch.from_numpy(obj).to(dev)).cpu().numpy()
    per_view = [float(np.linalg.norm(uv[v] - pts, axis=1).mean()) for v, pts in enumerate(img_pts)]
    worst = int(np.argmax(per_view))
    print(f"per-view mean reproj error: "
          f"{[round(e, 3) for e in per_view]} -> dropping view {worst}")
    res2 = run_calib([p for i, p in enumerate(img_pts) if i != worst])
    print(f"re-calibrated over {len(img_pts)-1} views: RMS = {res2.rms:.3f} px")

    best = res2 if res2.rms < res.rms else res
    ok = bool(best.rms < 0.8
              and abs(best.K[0, 0] - K_GT[0, 0]) < 0.03 * K_GT[0, 0]
              and abs(best.K[1, 1] - K_GT[1, 1]) < 0.03 * K_GT[1, 1])
    print("OK" if ok else "DEGRADED")
    return dict(out, first=_k_figures(res), per_view=per_view, dropped=worst,
                after_drop=_k_figures(res2), ok=ok)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
