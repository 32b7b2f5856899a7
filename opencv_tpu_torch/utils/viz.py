"""Visualization: trajectory/map viewing + drawing + display surface
(port of opencv_tpu/utils/viz.py: host numpy, plots through matplotlib
imported when needed, `imshow` through the port's `imwrite`).

Fills two reference capability slots on a headless host:
- `viz` (9.7k LoC of VTK bindings, viz/src/): 3-D trajectory + landmark
  viewing — here rendered to PNG via matplotlib (Agg), the honest
  equivalent of Viz3d::spin one frame at a time;
- `highgui` (window_*.cpp backends) + features2d drawing helpers
  (drawKeypoints/drawMatches, features2d/src/draw.cpp): imshow becomes
  write-to-file, and the overlay painters are pure numpy so they also
  serve the TBD sample's on-frame annotations (samples/gpu/tbd.cpp
  drawing/FPS overlays).
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------- drawing -----

def to_rgb(img: np.ndarray) -> np.ndarray:
    """Grayscale [H,W] -> RGB u8 [H,W,3]."""
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if g.ndim == 3:
        return g
    return np.stack([g] * 3, axis=-1)


def draw_rect(img: np.ndarray, box, color=(0, 255, 0), thickness: int = 1):
    """In-place rectangle on RGB u8; box = (x, y, w, h)."""
    x, y, w, h = [int(round(v)) for v in box]
    H, W = img.shape[:2]
    for t in range(thickness):
        x0, y0 = max(x - t, 0), max(y - t, 0)
        x1, y1 = min(x + w + t, W - 1), min(y + h + t, H - 1)
        img[y0, x0:x1 + 1] = color
        img[y1, x0:x1 + 1] = color
        img[y0:y1 + 1, x0] = color
        img[y0:y1 + 1, x1] = color
    return img


def draw_keypoints(img: np.ndarray, xy, valid=None, color=(255, 0, 0),
                   radius: int = 2) -> np.ndarray:
    """drawKeypoints analog: cross markers on an RGB copy."""
    out = to_rgb(img).copy()
    xy = np.asarray(xy)
    if valid is None:
        valid = np.ones(len(xy), bool)
    H, W = out.shape[:2]
    for (x, y), ok in zip(xy, np.asarray(valid)):
        if not ok:
            continue
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            out[max(yi - radius, 0):yi + radius + 1, xi] = color
            out[yi, max(xi - radius, 0):xi + radius + 1] = color
    return out


def _line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).round().astype(int)
    H, W = img.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color
    return img


def draw_matches(img0, xy0, img1, xy1, pairs, valid=None) -> np.ndarray:
    """drawMatches analog: side-by-side composite with match lines.
    pairs: [M, 2] (idx into xy0, idx into xy1)."""
    a, b = to_rgb(img0), to_rgb(img1)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    xy0 = np.asarray(xy0)
    xy1 = np.asarray(xy1)
    pairs = np.asarray(pairs)
    if valid is None:
        valid = np.ones(len(pairs), bool)
    rng = np.random.default_rng(0)
    for (i, j), ok in zip(pairs, np.asarray(valid)):
        if not ok:
            continue
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        _line(canvas, xy0[i], (xy1[j][0] + off, xy1[j][1]), color)
    return canvas


def put_text(img: np.ndarray, text: str, org, color=(255, 255, 0)):
    """Tiny 5x7 bitmap-font putText analog (enough for FPS overlays)."""
    font = _FONT
    x0, y0 = int(org[0]), int(org[1])
    for ch in text.upper():
        glyph = font.get(ch)
        if glyph is not None:
            for r, row in enumerate(glyph):
                for c, bit in enumerate(row):
                    if bit == "1":
                        y, x = y0 + r, x0 + c
                        if 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
                            img[y, x] = color
        x0 += 6
    return img


_FONT = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    " ": ["000", "000", "000", "000", "000"],
    "F": ["111", "100", "111", "100", "100"],
    "P": ["111", "101", "111", "100", "100"],
    "S": ["111", "100", "111", "001", "111"],
    ":": ["000", "010", "000", "010", "000"],
}


# ------------------------------------------------------ display slot ---

def imshow(path: str, img: np.ndarray) -> None:
    """highgui imshow analog on a headless host: write a PNG."""
    from opencv_tpu_torch.io.image import imwrite

    imwrite(path, np.asarray(img))


# ----------------------------------------------------- 3-D trajectory ---

def plot_trajectory(
    path: str,
    poses: np.ndarray,
    gt_poses: np.ndarray | None = None,
    landmarks: np.ndarray | None = None,
    elev: float = -40.0,
    azim: float = -90.0,
) -> None:
    """Render camera trajectory (+optional ground truth and landmark
    cloud) to a PNG — the viz-module capability (trajectory/map viewing)
    without a display. poses: [T, 3] camera centers (or [T, 4, 4])."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def centers(p):
        p = np.asarray(p)
        if p.ndim == 3:  # [T,4,4] world-from-cam or cam-from-world
            return p[:, :3, 3]
        return p

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    c = centers(poses)
    ax.plot(c[:, 0], c[:, 1], c[:, 2], "-", color="#1f77b4", label="estimate")
    if gt_poses is not None:
        g = centers(gt_poses)
        ax.plot(g[:, 0], g[:, 1], g[:, 2], "--", color="#2ca02c", label="gt")
    if landmarks is not None and len(landmarks):
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=1, alpha=0.3,
                   color="#7f7f7f", label="map")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=elev, azim=azim)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_birdseye(path: str, poses: np.ndarray,
                  gt_poses: np.ndarray | None = None) -> None:
    """2-D top-down trajectory plot (the KITTI-style x/z view)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(poses)
    if p.ndim == 3:
        p = p[:, :3, 3]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(p[:, 0], p[:, 2], "-", color="#1f77b4", label="estimate")
    if gt_poses is not None:
        g = np.asarray(gt_poses)
        if g.ndim == 3:
            g = g[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "--", color="#2ca02c", label="gt")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def flow_to_color(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """Dense-flow visualization: HSV color wheel (hue = direction,
    saturation = magnitude) -> RGB u8 [H, W, 3]. The modern replacement
    for cudalegacy's needle-map visualizer (NCVVisualize needle maps)."""
    f = np.asarray(flow, np.float32)
    u, v = f[..., 0], f[..., 1]
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    ang = (np.arctan2(v, u) + np.pi) / (2 * np.pi)  # 0..1
    sat = np.clip(mag / max_mag, 0, 1)
    h6 = ang * 6.0
    i = np.floor(h6).astype(int) % 6
    fpart = h6 - np.floor(h6)
    p = 1.0 - sat
    q = 1.0 - sat * fpart
    t = 1.0 - sat * (1.0 - fpart)
    one = np.ones_like(sat)
    lut = [
        (one, t, p), (q, one, p), (p, one, t),
        (p, q, one), (t, p, one), (one, p, q),
    ]
    r = np.choose(i, [c[0] for c in lut])
    g = np.choose(i, [c[1] for c in lut])
    b = np.choose(i, [c[2] for c in lut])
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
