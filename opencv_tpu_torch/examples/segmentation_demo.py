"""Segmentation and tracking showcase (port of examples/segmentation_demo.py,
the analog of the reference's samples/cpp/{grabcut,watershed,camshiftdemo}.cpp
trio, headless).

    python -m opencv_tpu_torch.examples.segmentation_demo [--cpu]

GrabCut foreground extraction of a red blob on green (70x90), a marker
watershed of two basins, and a CamShift track of a bright disc over 7
frames of 120x160, all from one generator (seed 0). Exits 0 when the
GrabCut IoU exceeds 0.8, the mean CamShift centre error is below 6 px and
both basins exceed 500 px.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import camshift, grabcut, watershed

H, W = 70, 90
RECT = (18, 10, 58, 52)
WINDOW = (25, 35, 30, 30)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.segmentation_demo",
                                 description="GrabCut, watershed and CamShift on synthetic scenes.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap


def grabcut_scene(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A red-ish ellipse on green ground with N(0, 6) noise: (image f32
    [H, W, 3] clipped to [0, 255], the ellipse's mask)."""
    img = np.zeros((H, W, 3), np.float32)
    img[..., 1] = 120
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((xx - 45) ** 2 / 400 + (yy - 35) ** 2 / 250) < 1
    img[blob] = [40, 40, 200]
    img += rng.normal(0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255), blob


def watershed_scene() -> tuple[np.ndarray, np.ndarray]:
    """Two Gaussian valleys along x and a marker in each: (surface f32,
    markers i32)."""
    xx = np.mgrid[0:H, 0:W][1]
    surface = 100 - 80 * np.exp(-((xx - 25) ** 2) / 200) - 80 * np.exp(-((xx - 65) ** 2) / 200)
    markers = np.zeros((H, W), np.int32)
    markers[30:34, 20:28] = 1
    markers[30:34, 60:68] = 2
    return surface.astype(np.float32), markers


def camshift_frames(rng: np.random.Generator) -> tuple[list[np.ndarray], list[tuple]]:
    """7 frames of 120x160: uniform(20, 60) noise and a disc of radius 14
    at 210 moving (9, 4) px a frame from (40, 50). (frames, centres)."""
    centers = [(40 + 9 * t, 50 + 4 * t) for t in range(7)]
    yy, xx = np.mgrid[0:120, 0:160]
    frames = []
    for cx, cy in centers:
        f = rng.uniform(20, 60, (120, 160)).astype(np.float32)
        frames.append(np.where((xx - cx) ** 2 + (yy - cy) ** 2 < 14 ** 2, 210.0, f).astype(np.float32))
    return frames, centers


def main(argv=None) -> dict:
    """The three parts and the verdict; besides the printed figures, the
    GrabCut mask, the watershed labels and the CamShift windows."""
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    rng = np.random.default_rng(0)

    # GrabCut
    img, blob = grabcut_scene(rng)
    gc = grabcut.grab_cut_stats(img, rect=RECT, iter_count=4, device=dev)
    mask = gc.mask.cpu().numpy()
    fg = mask % 2 == 1
    iou = float((fg & blob).sum() / max((fg | blob).sum(), 1))
    print(f"grabcut: fg={int(fg.sum())} px, IoU vs truth = {iou:.3f}")

    # watershed
    surface, markers = watershed_scene()
    ws = watershed.watershed_stats(surface, markers, device=dev)
    labels = ws.labels.cpu().numpy()
    sizes = {k: int((labels == k).sum()) for k in (1, 2)}
    dams = int((labels == -1).sum())
    print(f"watershed: basin sizes = {sizes}, dam px = {dams}")

    # CamShift: a 32-bin density histogram of frame 0's window, then the track
    frames, centers = camshift_frames(rng)
    f0 = torch.from_numpy(frames[0]).to(dev)
    tmpl = f0[WINDOW[1]:WINDOW[1] + WINDOW[3], WINDOW[0]:WINDOW[0] + WINDOW[2]]
    hist = camshift.calc_hist([tmpl], [32], [(0, 256)], density=True) * 255.0
    track = camshift.track_window_sequence([[f] for f in frames[1:]], hist, [(0, 256)], WINDOW,
                                           device=dev)
    errs = [float(np.hypot(b[0][0] - c[0], b[0][1] - c[1])) for (b, _), c in zip(track, centers[1:])]
    err = float(np.mean(errs))
    print(f"camshift: mean center error = {err:.2f} px over {len(errs)} frames")
    ok = bool(iou > 0.8 and err < 6 and sizes[1] > 500 and sizes[2] > 500)
    print("OK" if ok else "DEGRADED")
    return dict(grabcut_fg_px=int(fg.sum()), grabcut_iou=iou, grabcut_sweeps=gc.sweeps,
                basin_sizes=sizes, dam_px=dams, watershed_sweeps=ws.sweeps, camshift_err_px=err,
                camshift_frames=len(errs), ok=ok, mask=mask, labels=labels,
                windows=[w for _, w in track])


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
