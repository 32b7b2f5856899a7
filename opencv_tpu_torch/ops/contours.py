"""Contour extraction + shape analysis (port of opencv_tpu/ops/contours.py).

Reference capability slots:
  - findContours / drawContours  (imgproc/src/contours.cpp:1 — Suzuki-Abe
    border following with hierarchy)
  - moments / HuMoments          (imgproc/src/moments.cpp:1)
  - contourArea / arcLength      (imgproc/src/shapedescr.cpp:1)
  - convexHull / isContourConvex (imgproc/src/convhull.cpp:1)
  - approxPolyDP                 (imgproc/src/approx.cpp:1)
  - fitEllipse / fitLine / minEnclosingCircle (imgproc/src/shapedescr.cpp)
  - minAreaRect / boxPoints      (imgproc/src/rotcalipers.cpp:1)
  - matchShapes                  (imgproc/src/matchcontours.cpp:1)
  - pointPolygonTest             (imgproc/src/geometry.cpp:1)

Host and device split as in the JAX package:
  - Border following, the hull, Douglas-Peucker, the calipers, Welzl's
    circle, the rotated-rectangle clip and the enclosing triangle are
    sequential control; they are the JAX module's host numpy, copied
    here, so contours, hierarchy and these shapes are the same.
  - Moments, Hu, area, arc length, bounding boxes, convexity, the
    ellipse and line fits, matchShapes and pointPolygonTest are tensor
    math on the device with `n_valid` masks over padded point lists. Their
    sums are reductions whose order the library chooses: they agree with
    the JAX functions to a few f32 ulps (relative), integer outputs
    exactly. A tensor argument stays on its device; numpy goes to the
    card unless `device="cpu"`.

Coordinate convention matches the reference: points are (x, y) integer
pixel positions, outer borders traced counter-clockwise in image
coordinates (y down).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.device import no_tf32, on_device, true_div

__all__ = [
    "find_contours",
    "contour_moments",
    "image_moments",
    "hu_moments",
    "contour_area",
    "arc_length",
    "bounding_rect",
    "convex_hull",
    "is_contour_convex",
    "approx_poly_dp",
    "fit_ellipse",
    "fit_line",
    "min_area_rect",
    "box_points",
    "min_enclosing_circle",
    "match_shapes",
    "point_polygon_test",
    "rotated_rect_intersection",
    "min_enclosing_triangle",
]


# --------------------------------------------------------------------------
# findContours — wavefront Suzuki-Abe on host
# --------------------------------------------------------------------------

# Moore neighbourhood in the reference's clockwise order starting east
# (contours.cpp icvFetchContour deltas), (dx, dy):
_MOORE = np.array(
    [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)],
    np.int32,
)


class Contours(NamedTuple):
    """SoA contour record: fixed-capacity padded point lists + masks.

    points:  [C, K, 2] int32 (x, y), padded with the last valid point
    lengths: [C] int32 number of valid points per contour
    valid:   [C] bool contour slot in use
    is_hole: [C] bool hole border (traced around background)
    parent:  [C] int32 index of enclosing contour, -1 for outermost
             (the reference's hierarchy[3] slot)
    """

    points: np.ndarray
    lengths: np.ndarray
    valid: np.ndarray
    is_hole: np.ndarray
    parent: np.ndarray


def _trace_border(padded: np.ndarray, start_yx: tuple[int, int],
                  outer: bool, max_pts: int) -> np.ndarray:
    """Moore border following from a start pixel. `padded` is the binary
    image with a 1-px zero frame; returns [K,2] (x,y) in unpadded coords.

    Mirrors icvFetchContour (contours.cpp): for an outer border the
    initial backtrack direction is west; for a hole it is east.
    """
    y0, x0 = start_yx
    # initial search: from the backtrack neighbour, clockwise
    back = 4 if outer else 0  # index into _MOORE: west / east
    pts = []
    y, x = y0, x0
    prev_dir = back
    for _ in range(max_pts):
        pts.append((x - 1, y - 1))
        found = -1
        # scan the 8 neighbours clockwise starting just after backtrack
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            dy = _MOORE[d, 1]
            dx = _MOORE[d, 0]
            if padded[y + dy, x + dx]:
                found = d
                break
        if found < 0:  # isolated pixel
            break
        y += _MOORE[found, 1]
        x += _MOORE[found, 0]
        prev_dir = (found + 4) % 8  # new backtrack = reverse of motion
        if (y, x) == (y0, x0) and len(pts) > 1:
            # closed loop: check the second point repeats too (Suzuki
            # stop criterion — avoids early exit on 1-px necks)
            d2 = -1
            py, px = y, x
            pd = prev_dir
            for k in range(1, 9):
                d = (pd + k) % 8
                if padded[py + _MOORE[d, 1], px + _MOORE[d, 0]]:
                    d2 = d
                    break
            if d2 >= 0:
                ny, nx = py + _MOORE[d2, 1], px + _MOORE[d2, 0]
                if (nx - 1, ny - 1) == pts[1 % len(pts)]:
                    break
            else:
                break
    return np.asarray(pts, np.int32)


def find_contours(
    mask: np.ndarray,
    max_contours: int = 256,
    max_points: int = 4096,
    min_points: int = 1,
) -> Contours:
    """Binary-image border extraction with outer/hole classification and
    parent links (cv::findContours RETR_CCOMP-style hierarchy; method =
    CHAIN_APPROX_NONE — every border pixel is emitted).

    Host-side by design (SURVEY §7(f)); the returned SoA record is padded
    to static shapes so the tensor shape analysis below can batch them.
    """
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask).astype(bool)
    h, w = mask.shape
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = mask

    # raster scan for border starts, as in contours.cpp's main scan:
    # outer start: fg pixel whose WEST neighbour is bg and not yet traced;
    # hole start: fg pixel whose EAST neighbour is bg.
    fg = padded
    west_bg = ~np.roll(fg, 1, axis=1) & fg
    east_bg = ~np.roll(fg, -1, axis=1) & fg

    traced = np.zeros_like(padded, bool)
    out_pts = np.zeros((max_contours, max_points, 2), np.int32)
    out_len = np.zeros((max_contours,), np.int32)
    out_hole = np.zeros((max_contours,), bool)
    out_valid = np.zeros((max_contours,), bool)
    n = 0

    # label map of already-extracted borders for parent lookup
    owner = -np.ones((h + 2, w + 2), np.int32)

    ys, xs = np.nonzero(west_bg | east_bg)
    for y, x in zip(ys.tolist(), xs.tolist()):
        if n >= max_contours:
            break
        is_outer = west_bg[y, x] and not traced[y, x]
        is_hole = east_bg[y, x] and not traced[y, x] and not is_outer
        if not (is_outer or is_hole):
            continue
        pts = _trace_border(padded, (y, x), is_outer, max_points)
        if pts.shape[0] < min_points:
            continue
        k = min(pts.shape[0], max_points)
        out_pts[n, :k] = pts[:k]
        out_pts[n, k:] = pts[k - 1]
        out_len[n] = k
        out_hole[n] = is_hole
        out_valid[n] = True
        traced[pts[:, 1] + 1, pts[:, 0] + 1] = True
        owner[pts[:, 1] + 1, pts[:, 0] + 1] = n
        n += 1

    # parent: walk west from each contour's topmost-leftmost point; the
    # first traced pixel belonging to another contour that encloses it
    parent = -np.ones((max_contours,), np.int32)
    for i in range(n):
        y, x = out_pts[i, 0, 1] + 1, out_pts[i, 0, 0] + 1
        crossings: dict[int, int] = {}
        for xx in range(x - 1, 0, -1):
            o = owner[y, xx]
            if o >= 0 and o != i:
                crossings[o] = crossings.get(o, 0) + 1
        for o, c in crossings.items():
            if c % 2 == 1:
                parent[i] = o
                break
    return Contours(out_pts, out_len, out_valid, out_hole, parent)


def draw_contours(
    shape: tuple[int, int], contours: Contours, thickness: int = 1
) -> np.ndarray:
    """Rasterize contour borders into a uint8 mask (cv::drawContours with
    thickness>=1 border mode; filled mode is point_polygon_test >= 0)."""
    h, w = shape
    img = np.zeros((h, w), np.uint8)
    r = max(0, thickness // 2)
    for i in range(contours.points.shape[0]):
        if not contours.valid[i]:
            continue
        k = int(contours.lengths[i])
        pts = contours.points[i, :k]
        for x, y in pts:
            img[max(0, y - r): y + r + 1, max(0, x - r): x + r + 1] = 255
    return img


# --------------------------------------------------------------------------
# Moments (contour + raster) and Hu invariants
# --------------------------------------------------------------------------


class Moments(NamedTuple):
    m00: torch.Tensor
    m10: torch.Tensor
    m01: torch.Tensor
    m20: torch.Tensor
    m11: torch.Tensor
    m02: torch.Tensor
    m30: torch.Tensor
    m21: torch.Tensor
    m12: torch.Tensor
    m03: torch.Tensor
    mu20: torch.Tensor
    mu11: torch.Tensor
    mu02: torch.Tensor
    mu30: torch.Tensor
    mu21: torch.Tensor
    mu12: torch.Tensor
    mu03: torch.Tensor


def _shift_moments(m, dx, dy) -> tuple:
    """Exact raw-moment translation: moments of coords shifted by (dx,dy)
    from moments computed in the centered frame."""
    m00, m10, m01, m20, m11, m02, m30, m21, m12, m03 = m
    M10 = m10 + dx * m00
    M01 = m01 + dy * m00
    M20 = m20 + 2 * dx * m10 + dx * dx * m00
    M11 = m11 + dx * m01 + dy * m10 + dx * dy * m00
    M02 = m02 + 2 * dy * m01 + dy * dy * m00
    M30 = m30 + 3 * dx * m20 + 3 * dx * dx * m10 + dx ** 3 * m00
    M21 = (m21 + dy * m20 + 2 * dx * m11 + 2 * dx * dy * m10
           + dx * dx * m01 + dx * dx * dy * m00)
    M12 = (m12 + dx * m02 + 2 * dy * m11 + 2 * dx * dy * m01
           + dy * dy * m10 + dy * dy * dx * m00)
    M03 = m03 + 3 * dy * m02 + 3 * dy * dy * m01 + dy ** 3 * m00
    return m00, M10, M01, M20, M11, M02, M30, M21, M12, M03


def _central(m) -> tuple:
    m00, m10, m01, m20, m11, m02, m30, m21, m12, m03 = m
    zero = m00 == 0
    inv = torch.where(zero, torch.zeros_like(m00), 1.0 / torch.where(zero, torch.ones_like(m00), m00))
    cx = m10 * inv
    cy = m01 * inv
    mu20 = m20 - m10 * cx
    mu11 = m11 - m10 * cy
    mu02 = m02 - m01 * cy
    mu30 = m30 - 3 * cx * m20 + 2 * cx * cx * m10
    mu21 = m21 - 2 * cx * m11 - cy * m20 + 2 * cx * cx * m01
    mu12 = m12 - 2 * cy * m11 - cx * m02 + 2 * cy * cy * m10
    mu03 = m03 - 3 * cy * m02 + 2 * cy * cy * m01
    return mu20, mu11, mu02, mu30, mu21, mu12, mu03


def _points(pts, n_valid, device):
    """(points f32 [K, 2] on the device, n_valid as an i64 tensor there, K)."""
    p = on_device(pts, device).to(torch.float32)
    k = p.shape[0]
    if n_valid is None:
        nv = torch.full((), k, dtype=torch.int64, device=p.device)
    else:
        nv = torch.as_tensor(n_valid, device=p.device).to(torch.int64)
    return p, nv, k


def _ring(k: int, n_valid: torch.Tensor):
    """(index, index of the next point closing the ring at n_valid, live)."""
    idx = torch.arange(k, device=n_valid.device)
    nxt = torch.where(idx + 1 >= n_valid, torch.zeros_like(idx), idx + 1)
    return idx, nxt, idx < n_valid


def _masked_mean(p: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    lv = live[:, None] if p.ndim == 2 else live
    s = torch.where(lv, p, torch.zeros_like(p)).sum(0)
    return s / torch.clamp(live.sum(), min=1).to(p.dtype)


def contour_moments(pts, n_valid=None, device=None) -> Moments:
    """Green's-theorem contour moments (cv::moments on a point contour,
    moments.cpp contourMoments): exact polygon moments up to order 3.

    pts: [K, 2] float (x, y), closed implicitly; n_valid masks padding.
    The sums run on centroid-centred coordinates (stable in f32) and the
    raw moments are rebuilt by the exact shift identities, as the JAX
    function does."""
    pts, n_valid, k = _points(pts, n_valid, device)
    _, nxt, live = _ring(k, n_valid)
    ctr = _masked_mean(pts, live)
    pts = pts - ctr
    xi = pts[:, 0]
    yi = pts[:, 1]
    xj = pts[nxt, 0]
    yj = pts[nxt, 1]
    # cross term with the reference's orientation convention
    # (moments.cpp contourMoments: a00 = x_i*y_{i+1} - x_{i+1}*y_i gives
    # POSITIVE area for cv-ordered outer borders)
    a = torch.where(live, xj * yi - xi * yj, torch.zeros_like(xi))

    m00 = a.sum() / 2
    m10 = true_div((a * (xi + xj)).sum(), 6)
    m01 = true_div((a * (yi + yj)).sum(), 6)
    m20 = true_div((a * (xi * xi + xi * xj + xj * xj)).sum(), 12)
    m11 = true_div((a * (2 * xi * yi + xi * yj + xj * yi + 2 * xj * yj)).sum(), 24)
    m02 = true_div((a * (yi * yi + yi * yj + yj * yj)).sum(), 12)
    m30 = true_div((a * (xi + xj) * (xi * xi + xj * xj)).sum(), 20)
    m21 = true_div((a * (3 * xi * xi * yi + 2 * xi * xj * yi + xj * xj * yi
                         + xi * xi * yj + 2 * xi * xj * yj + 3 * xj * xj * yj)).sum(), 60)
    m12 = true_div((a * (3 * yi * yi * xi + 2 * yi * yj * xi + yj * yj * xi
                         + yi * yi * xj + 2 * yi * yj * xj + 3 * yj * yj * xj)).sum(), 60)
    m03 = true_div((a * (yi + yj) * (yi * yi + yj * yj)).sum(), 20)

    # the reference normalizes orientation: all moments flipped so that
    # m00 > 0 (moments.cpp:165-183 db1_* sign selection)
    s = torch.where(m00 < 0, -torch.ones_like(m00), torch.ones_like(m00))
    centered = tuple(s * v for v in (m00, m10, m01, m20, m11, m02, m30, m21, m12, m03))
    raw = _shift_moments(centered, ctr[0], ctr[1])
    # central moments are translation invariant: evaluate them in the
    # centered frame, where f32 cancellation is benign
    return Moments(*raw, *_central(centered))


def image_moments(img, device=None) -> Moments:
    """Raster moments of an intensity/binary image (cv::moments on Mat,
    moments.cpp): m_pq = sum img[y,x] * x^p * y^q, accumulated around the
    image centre in f32 and shifted back exactly."""
    img = on_device(img, device).to(torch.float32)
    h, w = img.shape
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    x = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    yv = torch.arange(h, dtype=torch.float32, device=img.device) - cy
    sy = img.sum(1)  # [h] row sums — reduce columns first
    sy1 = (img * x).sum(1)
    sy2 = (img * x * x).sum(1)
    sy3 = (img * x * x * x).sum(1)
    centered = (sy.sum(), sy1.sum(), (sy * yv).sum(), sy2.sum(), (sy1 * yv).sum(),
                (sy * yv * yv).sum(), sy3.sum(), (sy2 * yv).sum(), (sy1 * yv * yv).sum(),
                (sy * yv * yv * yv).sum())
    raw = _shift_moments(centered, cx, cy)
    return Moments(*raw, *_central(centered))


def hu_moments(m: Moments) -> torch.Tensor:
    """The 7 Hu rotation invariants (cv::HuMoments, moments.cpp:885)."""
    m00 = torch.where(m.m00 == 0, torch.ones_like(m.m00), m.m00.abs())
    s2 = m00 * m00
    s3 = s2 * torch.sqrt(m00)
    n20, n11, n02 = m.mu20 / s2, m.mu11 / s2, m.mu02 / s2
    n30, n21, n12, n03 = m.mu30 / s3, m.mu21 / s3, m.mu12 / s3, m.mu03 / s3
    t0 = n30 + n12
    t1 = n21 + n03
    q0 = t0 * t0
    q1 = t1 * t1
    h0 = n20 + n02
    h1 = (n20 - n02) ** 2 + 4 * n11 * n11
    h2 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h3 = q0 + q1
    h4 = (n30 - 3 * n12) * t0 * (q0 - 3 * q1) + (3 * n21 - n03) * t1 * (3 * q0 - q1)
    h5 = (n20 - n02) * (q0 - q1) + 4 * n11 * t0 * t1
    h6 = (3 * n21 - n03) * t0 * (q0 - 3 * q1) - (n30 - 3 * n12) * t1 * (3 * q0 - q1)
    return torch.stack([h0, h1, h2, h3, h4, h5, h6])


# --------------------------------------------------------------------------
# Scalar descriptors
# --------------------------------------------------------------------------


def contour_area(pts, n_valid=None, oriented: bool = False, device=None) -> torch.Tensor:
    """Shoelace polygon area (cv::contourArea, shapedescr.cpp:270):
    signed by point order when oriented=True (the reference's sign:
    positive for counter-clockwise in standard axes)."""
    pts, n_valid, k = _points(pts, n_valid, device)
    _, nxt, live = _ring(k, n_valid)
    c = pts - _masked_mean(pts, live)
    cross = c[:, 0] * c[nxt, 1] - c[nxt, 0] * c[:, 1]
    a = torch.where(live, cross, torch.zeros_like(cross)).sum() / 2.0
    return a if oriented else a.abs()


def arc_length(pts, n_valid=None, closed: bool = True, device=None) -> torch.Tensor:
    """Perimeter (cv::arcLength, shapedescr.cpp)."""
    pts, n_valid, k = _points(pts, n_valid, device)
    idx, nxt, live = _ring(k, n_valid)
    d = pts[nxt] - pts
    seg = torch.sqrt((d * d).sum(1))
    if not closed:
        live = live & (idx + 1 < n_valid)
    return torch.where(live, seg, torch.zeros_like(seg)).sum()


def bounding_rect(pts, n_valid=None, device=None) -> torch.Tensor:
    """Axis-aligned integer bounding box (x, y, w, h) — cv::boundingRect."""
    pts, n_valid, k = _points(pts, n_valid, device)
    _, _, live = _ring(k, n_valid)
    big = torch.full((k,), 1e18, dtype=torch.float32, device=pts.device)
    x0 = torch.where(live, pts[:, 0], big).min()
    y0 = torch.where(live, pts[:, 1], big).min()
    x1 = torch.where(live, pts[:, 0], -big).max()
    y1 = torch.where(live, pts[:, 1], -big).max()
    return torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1]).to(torch.int32)


# --------------------------------------------------------------------------
# Convex hull (Andrew monotone chain, host) + convexity test (device)
# --------------------------------------------------------------------------


def convex_hull(pts: np.ndarray, clockwise: bool = False) -> np.ndarray:
    """Convex hull point list (cv::convexHull, convhull.cpp). Host-side
    O(n log n) monotone chain — hulls gate tiny downstream problems
    (calipers, fitting), so a device formulation buys nothing."""
    p = np.unique(np.asarray(pts, np.float64).reshape(-1, 2), axis=0)
    if p.shape[0] <= 2:
        return p.astype(np.float32)
    # lexicographic sort is given by np.unique
    def half(points):
        out = []
        for q in points:
            while len(out) >= 2 and np.cross(out[-1] - out[-2], q - out[-2]) <= 0:
                out.pop()
            out.append(q)
        return out

    lower = half(p)
    upper = half(p[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1], np.float64)
    # hull is counter-clockwise in standard axes = clockwise in image
    # coords (y down); cv returns clockwise=False -> counter-clockwise
    # in image coords, so reverse
    if not clockwise:
        hull = hull[::-1]
    return hull.astype(np.float32)


def is_contour_convex(pts, n_valid=None, device=None) -> torch.Tensor:
    """cv::isContourConvex: all consecutive cross products share a sign."""
    pts, n_valid, k = _points(pts, n_valid, device)
    idx = torch.arange(k, device=pts.device)
    # clamped like XLA's gathers (indices past the end occur only in padding)
    i1 = torch.where(idx + 1 >= n_valid, idx + 1 - n_valid, idx + 1).clamp(max=k - 1)
    i2 = torch.where(idx + 2 >= n_valid, idx + 2 - n_valid, idx + 2).clamp(max=k - 1)
    a = pts[i1] - pts[idx]
    b = pts[i2] - pts[i1]
    cr = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    live = idx < n_valid
    return ~((live & (cr > 0)).any() & (live & (cr < 0)).any())


# --------------------------------------------------------------------------
# approxPolyDP — Douglas-Peucker (host, stack-based)
# --------------------------------------------------------------------------


def approx_poly_dp(pts: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """Ramer-Douglas-Peucker polyline simplification (cv::approxPolyDP,
    approx.cpp). Host-side: the recursion is data-dependent; inputs are
    single contours (small)."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    n = p.shape[0]
    if n < 3:
        return p.astype(np.float32)
    if closed:
        # split at the two farthest points to seed the recursion
        i0 = 0
        d = np.linalg.norm(p - p[i0], axis=1)
        i1 = int(np.argmax(d))
        keep = np.zeros(n, bool)
        keep[[i0, i1]] = True
        stack = [(i0, i1), (i1, i0)]
    else:
        keep = np.zeros(n, bool)
        keep[[0, n - 1]] = True
        stack = [(0, n - 1)]

    def seg_range(i, j):
        return np.arange(i + 1, j) if j > i else np.concatenate(
            [np.arange(i + 1, n), np.arange(0, j)]
        )

    while stack:
        i, j = stack.pop()
        idx = seg_range(i, j)
        if idx.size == 0:
            continue
        a, b = p[i], p[j]
        ab = b - a
        denom = np.linalg.norm(ab)
        if denom < 1e-12:
            d = np.linalg.norm(p[idx] - a, axis=1)
        else:
            d = np.abs(np.cross(ab, p[idx] - a)) / denom
        kmax = int(np.argmax(d))
        if d[kmax] > epsilon:
            m = int(idx[kmax])
            keep[m] = True
            stack.append((i, m))
            stack.append((m, j))
    return p[keep].astype(np.float32)


# --------------------------------------------------------------------------
# Fitting: ellipse (least squares on centred coords, like cv), line (PCA +
# IRLS for robust norms)
# --------------------------------------------------------------------------


def fit_ellipse(pts, n_valid=None, device=None):
    """Least-squares ellipse fit (cv::fitEllipse, shapedescr.cpp:345 —
    the same centered linear system, not the generalized eigenproblem).
    The 5-unknown least squares is solved by QR in f64 (the JAX function
    takes an f32 SVD solve).

    Returns (center[2], axes[2] full lengths, angle degrees)."""
    pts, n_valid, k = _points(pts, n_valid, device)
    live = (torch.arange(k, device=pts.device) < n_valid)[:, None]
    c = _masked_mean(pts, live[:, 0])
    xy = torch.where(live, pts - c, torch.zeros_like(pts))
    x = xy[:, 0]
    y = xy[:, 1]
    # solve [A B C D E] from x^2 A + xy B + y^2 C + x D + y E = 1
    M = torch.stack([x * x, x * y, y * y, x, y], 1)
    rhs = live.to(torch.float32)
    sol = torch.linalg.lstsq(M.double(), rhs.double(), driver="gels").solution[:, 0].float()
    A, B, C, D, E = sol
    # convert conic to center/axes/angle
    den = 4 * A * C - B * B
    cx = (B * E - 2 * C * D) / den
    cy = (B * D - 2 * A * E) / den
    Fc = -1.0 - A * cx * cx - B * cx * cy - C * cy * cy - D * cx - E * cy
    # normalized quadratic form: lambda eigenvalues of [[A, B/2],[B/2, C]]
    tr = A + C
    det = A * C - B * B / 4
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    l1 = tr / 2 - disc
    l2 = tr / 2 + disc
    s = -Fc
    a_ax = torch.sqrt(torch.clamp(s / l1, min=0.0))
    b_ax = torch.sqrt(torch.clamp(s / l2, min=0.0))
    ang = torch.rad2deg(0.5 * torch.atan2(B, A - C))
    # cv convention: report (center, (2b, 2a), angle deg of the minor axis)
    ang = torch.where(ang < 0, ang + 180.0, ang)
    return torch.stack([cx, cy]) + c, torch.stack([2 * b_ax, 2 * a_ax]), ang


_LINE_WEIGHTS = {
    "l1": lambda r: 1.0 / r,
    "l12": lambda r: 1.0 / torch.sqrt(1.0 + true_div(r * r, 2)),
    "huber": lambda r: torch.where(r < 1.345, torch.ones_like(r), torch.full_like(r, 1.345) / r),
    "fair": lambda r: 1.0 / (1.0 + true_div(r, 1.3998)),
    "welsch": lambda r: torch.exp(-(true_div(r, 2.9846) ** 2)),
}


def fit_line(pts, n_valid=None, dist_type: str = "l2", n_irls: int = 10,
             device=None) -> torch.Tensor:
    """cv::fitLine (shapedescr.cpp fitLine2D): returns [vx, vy, x0, y0].
    L2 = PCA; robust norms (l1, l12, huber, fair, welsch) via IRLS
    re-weighted PCA, a fixed-iteration form of the reference's loops. The
    direction is the top eigenvector of a 2x2 `eigh`, whose sign is the
    solver's."""
    pts, n_valid, k = _points(pts, n_valid, device)
    live = (torch.arange(k, device=pts.device) < n_valid).to(torch.float32)

    def pca(w):
        c = (pts * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1e-9)
        d = (pts - c) * torch.sqrt(w)[:, None]
        with no_tf32():
            cov = d.T @ d
        return torch.linalg.eigh(cov)[1][:, -1], c

    v, c = pca(live)
    if dist_type != "l2":
        if dist_type not in _LINE_WEIGHTS:
            raise ValueError(dist_type)
        weight = _LINE_WEIGHTS[dist_type]
        for _ in range(n_irls):
            r = ((pts[:, 0] - c[0]) * (-v[1]) + (pts[:, 1] - c[1]) * v[0]).abs()
            s = torch.clamp((r * live).sum() / torch.clamp(live.sum(), min=1.0), min=1e-7)
            v, c = pca(live * weight(torch.clamp(r / s, min=1e-7)))
    return torch.cat([v, c])


# --------------------------------------------------------------------------
# minAreaRect — rotating calipers, vectorized over hull edges
# --------------------------------------------------------------------------


def min_area_rect(pts: np.ndarray):
    """cv::minAreaRect (rotcalipers.cpp): the minimum-area rectangle has a
    side collinear with a hull edge, so evaluate ALL hull edges at once
    (vectorized) instead of the sequential caliper rotation.

    Returns (center[2], size[2], angle_degrees) like cv::RotatedRect.
    """
    hull = convex_hull(np.asarray(pts, np.float64))
    h = np.asarray(hull, np.float64)
    n = h.shape[0]
    if n == 1:
        return h[0].astype(np.float32), np.zeros(2, np.float32), np.float32(0)
    e = np.roll(h, -1, axis=0) - h  # [n,2] edges
    ln = np.linalg.norm(e, axis=1)
    keep = ln > 1e-12
    d = e[keep] / ln[keep][:, None]  # [m,2] unit edge dirs
    nrm = np.stack([-d[:, 1], d[:, 0]], axis=1)
    # project all hull points on each (dir, normal) frame: [m, n]
    pu = d @ h.T
    pv = nrm @ h.T
    w = pu.max(1) - pu.min(1)
    hh = pv.max(1) - pv.min(1)
    areas = w * hh
    i = int(np.argmin(areas))
    cu = (pu[i].max() + pu[i].min()) / 2
    cv_ = (pv[i].max() + pv[i].min()) / 2
    center = cu * d[i] + cv_ * nrm[i]
    angle = np.degrees(np.arctan2(d[i, 1], d[i, 0]))
    size = np.array([w[i], hh[i]])
    # normalize to cv convention: angle in [-90, 0) with size swapped
    while angle >= 90:
        angle -= 180
    while angle < -90:
        angle += 180
    if angle >= 0:
        angle -= 90
        size = size[::-1]
    return center.astype(np.float32), size.astype(np.float32), np.float32(angle)


def box_points(center, size, angle_deg) -> np.ndarray:
    """cv::boxPoints: the 4 rectangle corners."""
    a = np.radians(float(angle_deg))
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s], [s, c]])
    wd, hh = float(size[0]) / 2, float(size[1]) / 2
    corners = np.array([[-wd, -hh], [wd, -hh], [wd, hh], [-wd, hh]])
    return (corners @ R.T + np.asarray(center)).astype(np.float32)


def min_enclosing_circle(pts: np.ndarray):
    """cv::minEnclosingCircle — Welzl's algorithm (iterative move-to-front),
    host-side; exact minimal circle."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    rng = np.random.default_rng(0)
    p = p[rng.permutation(p.shape[0])]

    def circle2(a, b):
        c = (a + b) / 2
        return c, np.linalg.norm(a - c)

    def circle3(a, b, c):
        ax, ay = a
        bx, by = b
        cx, cy = c
        dd = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        if abs(dd) < 1e-12:
            # collinear: widest pair
            pairs = [(a, b), (a, c), (b, c)]
            ctr, r = max((circle2(u, v) for u, v in pairs), key=lambda t: t[1])
            return ctr, r
        ux = ((ax ** 2 + ay ** 2) * (by - cy) + (bx ** 2 + by ** 2) * (cy - ay)
              + (cx ** 2 + cy ** 2) * (ay - by)) / dd
        uy = ((ax ** 2 + ay ** 2) * (cx - bx) + (bx ** 2 + by ** 2) * (ax - cx)
              + (cx ** 2 + cy ** 2) * (bx - ax)) / dd
        ctr = np.array([ux, uy])
        return ctr, np.linalg.norm(a - ctr)

    def inside(ctr, r, q):
        return np.linalg.norm(q - ctr) <= r * (1 + 1e-10) + 1e-10

    ctr, r = p[0], 0.0
    for i in range(1, p.shape[0]):
        if inside(ctr, r, p[i]):
            continue
        ctr, r = p[i], 0.0
        for j in range(i):
            if inside(ctr, r, p[j]):
                continue
            ctr, r = circle2(p[i], p[j])
            for q in range(j):
                if inside(ctr, r, p[q]):
                    continue
                ctr, r = circle3(p[i], p[j], p[q])
    return ctr.astype(np.float32), np.float32(r)


# --------------------------------------------------------------------------
# matchShapes + pointPolygonTest
# --------------------------------------------------------------------------


def match_shapes(hu_a, hu_b, method: int = 1, device=None) -> torch.Tensor:
    """cv::matchShapes I1/I2/I3 on Hu invariants (matchcontours.cpp)."""
    eps = 1e-5  # the reference's gate (matchcontours.cpp:50)

    def to_m(h):
        h = on_device(h, device).to(torch.float32)
        return h.abs() > eps, torch.sign(h) * torch.log10(torch.clamp(h.abs(), min=eps))

    la, ma = to_m(hu_a)
    lb, mb = to_m(hu_b)
    live = la & lb
    if method == 1:
        d = (1.0 / ma - 1.0 / mb).abs()
    elif method == 2:
        d = (ma - mb).abs()
    else:
        d = ((ma - mb) / ma).abs()
    d = torch.where(live, d, torch.zeros_like(d))
    return d.max() if method == 3 else d.sum()


def point_polygon_test(contour, points, measure_dist: bool = False, n_valid=None,
                       device=None) -> torch.Tensor:
    """cv::pointPolygonTest (geometry.cpp), batched over query points:
    sign (+inside / 0 edge / -outside) via crossing number, optionally
    signed euclidean distance to the polygon. [Q] result per point, from a
    [Q, K] edge grid."""
    c, n_valid, k = _points(contour, n_valid, device)
    q = on_device(points, c.device if device is None else device).to(torch.float32).reshape(-1, 2)
    _, nxt, live = _ring(k, n_valid)
    live = live[None, :]  # [1, K]
    a = c[None, :, :]  # [1, K, 2]
    b = c[nxt][None, :, :]
    p = q[:, None, :]  # [Q, 1, 2]

    ay, by, py = a[..., 1], b[..., 1], p[..., 1]
    ax, bx, px = a[..., 0], b[..., 0], p[..., 0]
    # crossing test (half-open rule like the reference)
    cond = (ay <= py) != (by <= py)
    t = (py - ay) / torch.where(by == ay, torch.ones_like(by), by - ay)
    xc = ax + t * (bx - ax)
    crosses = cond & (px < xc) & live
    inside = crosses.to(torch.int32).sum(1) % 2 == 1

    # on-edge test + distances
    ab = b - a
    ap = p - a
    tt = ((ab * ap).sum(-1) / torch.clamp((ab * ab).sum(-1), min=1e-12)).clamp(0.0, 1.0)
    proj = a + tt[..., None] * ab
    dd = p - proj
    d = torch.sqrt((dd * dd).sum(-1))
    d = torch.where(live, d, torch.full_like(d, float("inf")))
    dmin = d.amin(1)
    one = torch.ones_like(dmin)
    sign = torch.where(dmin < 1e-6, torch.zeros_like(dmin), torch.where(inside, one, -one))
    return sign * dmin if measure_dist else sign


# ---------------------------------------------------------------------------
# rotated-rectangle intersection + minimum enclosing triangle
# (imgproc/src/intersection.cpp:1, min_enclosing_triangle.cpp:1)

INTERSECT_NONE = 0
INTERSECT_PARTIAL = 1
INTERSECT_FULL = 2


def _clip_poly_halfplane(poly, a, b):
    """Sutherland-Hodgman: keep the side of directed edge a->b that is
    to the LEFT (inside for a CCW clip polygon)."""
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        e = b - a
        side_p = e[0] * (p - a)[1] - e[1] * (p - a)[0]
        side_q = e[0] * (q - a)[1] - e[1] * (q - a)[0]
        if side_p >= -1e-12:
            out.append(p)
        if (side_p > 1e-12 and side_q < -1e-12) or (
            side_p < -1e-12 and side_q > 1e-12
        ):
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return out


def rotated_rect_intersection(rect1, rect2):
    """cv::rotatedRectangleIntersection (imgproc/src/intersection.cpp:1).

    rect1/rect2: (center, size, angle_deg) RotatedRect triples.
    Returns (status, pts [N,2] f32): the intersection polygon vertices
    (unordered-dedup like cv2) and INTERSECT_NONE / PARTIAL / FULL
    (FULL = one rectangle entirely inside the other)."""
    p1 = [np.asarray(v, np.float64) for v in box_points(*rect1)]
    p2 = [np.asarray(v, np.float64) for v in box_points(*rect2)]

    def ensure_ccw(poly):
        area = 0.0
        for i in range(len(poly)):
            a, b = poly[i], poly[(i + 1) % len(poly)]
            area += a[0] * b[1] - b[0] * a[1]
        return poly if area > 0 else poly[::-1]

    p1 = ensure_ccw(p1)
    p2 = ensure_ccw(p2)
    poly = list(p1)
    for i in range(4):
        if not poly:
            break
        poly = _clip_poly_halfplane(poly, p2[i], p2[(i + 1) % 4])
    if not poly:
        return INTERSECT_NONE, np.zeros((0, 2), np.float32)
    # dedup nearly-identical vertices (cv2 does the same pass)
    uniq = []
    for p in poly:
        if all(np.linalg.norm(p - q) > 1e-6 for q in uniq):
            uniq.append(p)
    pts = np.asarray(uniq, np.float32).reshape(-1, 2)

    # FULL is decided the reference's way (intersection.cpp: after the
    # clip it tests whether every vertex of one rect lies inside the
    # other) — NOT by comparing areas, which misclassifies near-degenerate
    # thin rects at the tolerance boundary (ADVICE r4)
    scale = max(
        float(rect1[1][0]), float(rect1[1][1]),
        float(rect2[1][0]), float(rect2[1][1]), 1.0,
    )

    def all_inside(vs, poly_ccw):
        for p in vs:
            for i in range(4):
                a, b = poly_ccw[i], poly_ccw[(i + 1) % 4]
                cross = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (
                    p[0] - a[0]
                )
                if cross < -1e-6 * scale * scale:
                    return False
        return True

    if all_inside(p1, p2) or all_inside(p2, p1):
        return INTERSECT_FULL, pts
    return INTERSECT_PARTIAL, pts


def min_enclosing_triangle(pts: np.ndarray):
    """cv::minEnclosingTriangle (imgproc/src/min_enclosing_triangle.cpp:1).

    Every enclosing triangle can be shrunk until all three sides are
    hull support lines, so the minimum is a function of three support
    angles only; the reference walks O'Rourke's rotating configuration,
    here the same optimum is found by dense angle search + Nelder-Mead
    polish over (theta1, theta2, theta3) — host-side control, exact
    support offsets from the hull. Returns (triangle [3,2] f32, area)."""
    hull = np.asarray(convex_hull(np.asarray(pts, np.float64)), np.float64)
    hull = hull.reshape(-1, 2)
    if hull.shape[0] < 3:
        return hull.astype(np.float32), 0.0

    def support(theta):
        n = np.array([np.cos(theta), np.sin(theta)])
        return n, float((hull @ n).max())

    def tri_from_angles(angles):
        lines = [support(t) for t in angles]
        vs = []
        for i in range(3):
            (n1, c1), (n2, c2) = lines[i], lines[(i + 1) % 3]
            A = np.stack([n1, n2])
            det = np.linalg.det(A)
            if abs(det) < 1e-9:
                return None, np.inf
            vs.append(np.linalg.solve(A, np.array([c1, c2])))
        v = np.asarray(vs)
        d1, d2 = v[1] - v[0], v[2] - v[0]
        area = abs(d1[0] * d2[1] - d1[1] * d2[0]) / 2
        # the three support half-planes contain the hull by construction;
        # a degenerate (unbounded/inverted) configuration shows up as the
        # intersection points NOT being on the correct side
        for n, c in lines:
            if (v @ n - c).max() > 1e-6 * max(1.0, abs(c)):
                return None, np.inf
        return v, area

    # coarse: the optimum has a side FLUSH with a hull edge (Klee &
    # Laskowski), so seed theta1 at every hull edge normal and sweep the
    # other two angles on a grid; keep the best few seeds for polishing
    edge = np.roll(hull, -1, axis=0) - hull
    edge_angles = np.arctan2(edge[:, 0], -edge[:, 1])  # outward normals
    base = np.unique(np.round(edge_angles, 9))
    sweep = np.linspace(-0.8, 0.8, 9)
    # per flush edge: best (theta2, theta3) seed from the sweep grid
    seeds = []
    best_v, best_area = None, np.inf
    for t1 in base:
        sa, sx = np.inf, None
        for eps1 in sweep:
            for eps2 in sweep:
                ang = (
                    t1,
                    t1 + 2 * np.pi / 3 + eps1,
                    t1 + 4 * np.pi / 3 + eps2,
                )
                v, a = tri_from_angles(ang)
                if a < sa:
                    sa, sx = a, np.asarray(ang)
                if a < best_area:
                    best_v, best_area = v, a
        if sx is not None and np.isfinite(sa):
            seeds.append(sx)

    # polish (theta2, theta3) with theta1 PINNED flush to its edge — the
    # optimum keeps one side flush, so the pinned 2-D problem contains
    # it. Nested grid refinement (robust to the kinks where the support
    # vertex changes; Nelder-Mead stalls on them).
    for seed in seeds:
        t1 = float(seed[0])
        c2, c3 = float(seed[1]), float(seed[2])
        span = float(sweep[1] - sweep[0])
        for _ in range(6):
            grid2 = c2 + np.linspace(-span, span, 7)
            grid3 = c3 + np.linspace(-span, span, 7)
            sa = np.inf
            for g2 in grid2:
                for g3 in grid3:
                    v, a = tri_from_angles((t1, g2, g3))
                    if a < sa:
                        sa, c2n, c3n, sv = a, g2, g3, v
            c2, c3 = c2n, c3n
            span /= 3.0
            if sa < best_area:
                best_v, best_area = sv, sa
    return np.asarray(best_v, np.float32), float(best_area)
