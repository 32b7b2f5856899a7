"""Chessboard and circles-grid detection (port of opencv_tpu/ops/chessboard.py;
cv::findChessboardCorners, cv::cornerSubPix, cv::findCirclesGrid).

The JAX package's batched detector, on the device:
  1. saddle response: score = -det(Hessian) of the blurred image, radius-3
     NMS, a 3 px border, top-K over the whole image (a stable sort, so
     ties come out in `lax.top_k`'s order);
  2. sub-pixel refinement: cornerSubPix's normal equations for all K
     corners at once, an [K, 11, 11] bilinear gather and a batched 2x2
     solve per iteration, 10 fixed iterations (no host read).
The lattice ordering is host numpy, copied from the JAX package (this
package imports nothing of it): dedup, anchor-grown homography snapping,
window search, canonical orientation; and the circles grid's
PCA-lattice rounding over `ops.ccomp.detect_blobs`.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.ccomp import detect_blobs


# ------------------------------------------------------------ detection


def saddle_corners(img: torch.Tensor, max_corners: int = 256, blur_sigma: float = 1.5):
    """Saddle-point candidates of a gray image on its device: (xy [K, 2]
    f32, score [K], valid [K])."""
    g = imgproc.gaussian_blur(img.to(torch.float32), 7, blur_sigma)
    gx, gy = imgproc.scharr_derivatives(g)
    gxx, gxy = imgproc.scharr_derivatives(gx)
    _, gyy = imgproc.scharr_derivatives(gy)
    score = gxy * gxy - gxx * gyy  # -det(H): positive at saddles
    score = torch.where(score > 0, score, 0.0)
    # radius-3 NMS drops the Scharr-of-Scharr response's ~5 px sidelobes
    score = torch.where(imgproc.nms_2d(score, radius=3), score, 0.0)
    h, w = img.shape
    border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    border[3:h - 3, 3:w - 3] = True
    flat = torch.where(border, score, 0.0).reshape(-1)
    idx, _ = masked_top_k(flat, torch.ones_like(flat, dtype=torch.bool), max_corners)
    top = flat[idx]
    xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], 1)
    return xy, top, top > 0.05 * top[0]


def _solve2(a00, a01, a10, a11, b0, b1):
    """Batched 2x2 solve by LU with partial pivoting (LAPACK's gesv on a
    2x2: the row with the larger |first entry| pivots, the first on a
    tie)."""
    swap = a10.abs() > a00.abs()
    p00, p01, pb = (torch.where(swap, q, p) for p, q in ((a00, a10), (a01, a11), (b0, b1)))
    q10, q11, qb = (torch.where(swap, p, q) for p, q in ((a00, a10), (a01, a11), (b0, b1)))
    lf = q10 / p00
    x1 = (qb - lf * pb) / (q11 - lf * p01)
    x0 = (pb - p01 * x1) / p00
    return x0, x1


def corner_subpix(img: torch.Tensor, xy: torch.Tensor, win: int = 5, iters: int = 10) -> torch.Tensor:
    """cv::cornerSubPix analog on the image's device: iterate x <- x + G^-1 b
    over the (2 win + 1)^2 window, G = sum w g g^T, b = sum w g g^T (p - x),
    for all corners at once; each step clipped to 1 px; a fixed iteration
    count."""
    img = img.to(torch.float32)
    gx, gy = imgproc.scharr_derivatives(img)
    off = torch.arange(-win, win + 1, dtype=torch.float32, device=img.device)
    du = off[None, :].expand(off.numel(), off.numel())  # jnp.meshgrid's "xy" order
    dv = off[:, None].expand(off.numel(), off.numel())
    # the weights on the host: CUDA divides by a Python float as a multiply
    # by its reciprocal, which rounds otherwise than the CPU's division
    arg = -(du * du + dv * dv).cpu() / (2.0 * (win / 2.0) ** 2)
    wgt = torch.exp(arg.double()).to(torch.float32).to(img.device)
    eps = 1e-6
    p = xy.to(torch.float32)
    for _ in range(iters):
        pts = torch.stack([p[:, 0, None, None] + du, p[:, 1, None, None] + dv], -1)
        sgx = imgproc.bilinear_sample(gx, pts)
        sgy = imgproc.bilinear_sample(gy, pts)
        a = wgt * sgx * sgx
        b = wgt * sgx * sgy
        c = wgt * sgy * sgy
        bx = (a * du + b * dv).sum((1, 2))
        by = (b * du + c * dv).sum((1, 2))
        sb = b.sum((1, 2))
        d0, d1 = _solve2(a.sum((1, 2)) + eps, sb, sb, c.sum((1, 2)) + eps, bx, by)
        p = p + torch.stack([d0, d1], -1).clamp(-1.0, 1.0)
    return p


# ------------------------------------------------------- grid ordering


def _dedup(pts: np.ndarray, scores: np.ndarray, n_grid: int) -> np.ndarray:
    """Greedy strongest-first suppression with a pitch-adaptive radius:
    the saddle response has weak sidelobes 5-10px from each true corner;
    the lattice pitch estimated from the n_grid strongest candidates
    (overwhelmingly true corners) sets the kill radius."""
    order = np.argsort(-scores)
    strong = pts[order[: max(n_grid, 4)]]
    d = np.linalg.norm(strong[None] - strong[:, None], axis=-1)
    np.fill_diagonal(d, np.inf)
    pitch = float(np.median(d.min(axis=1)))
    r = 0.45 * pitch
    kept: list[int] = []
    for i in order:
        p = pts[i]
        if all(np.linalg.norm(p - pts[j]) >= r for j in kept):
            kept.append(i)
    return np.asarray(kept, int)


def _order_grid(pts: np.ndarray, rows: int, cols: int):
    """Snap candidate corners to an integer lattice via iterated
    homography fitting; return [rows*cols, 2] row-major or None."""
    n = pts.shape[0]
    if n < rows * cols:
        return None
    # lattice basis: the two shortest non-collinear median neighbor steps
    d = pts[None, :, :] - pts[:, None, :]  # [n,n,2]
    dist = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(dist, np.inf)
    nn = dist.min(axis=1)
    step = np.median(nn)
    if not np.isfinite(step) or step <= 1.0:
        return None

    # homography-snap iteration, seeded by each of several anchors
    best = None
    anchor_ids = np.argsort(pts[:, 0] + pts[:, 1])[:3]
    for aid in anchor_ids:
        g = _snap_from_anchor(pts, aid, step, rows, cols)
        if g is None:
            continue
        support, grid = g
        if best is None or support > best[0]:
            best = (support, grid)
    if best is None or best[0] < rows * cols:
        return None
    return best[1]


def _snap_from_anchor(pts, aid, step, rows, cols):
    """Grow integer lattice coordinates from one anchor point."""
    n = pts.shape[0]
    # initial axes: most common neighbor directions ~ step length
    d = pts[None, :, :] - pts[:, None, :]
    dist = np.linalg.norm(d, axis=-1)
    # ring excludes diagonal neighbors at sqrt(2)*step = 1.41*step —
    # with 4 diagonal neighbors per interior corner they can outvote the
    # axis directions in the angle histogram
    ring = (dist > 0.7 * step) & (dist < 1.3 * step)
    if not ring.any():
        return None
    vecs = d[ring]
    ang = np.arctan2(vecs[:, 1], vecs[:, 0]) % np.pi
    hist, edges = np.histogram(ang, bins=36, range=(0, np.pi))
    a1 = edges[np.argmax(hist)] + np.pi / 72
    # second axis: strongest direction > 30 deg away
    away = np.minimum(
        np.abs(edges[:-1] + np.pi / 72 - a1),
        np.pi - np.abs(edges[:-1] + np.pi / 72 - a1),
    ) > np.deg2rad(30)
    if not away.any():
        return None
    a2 = edges[:-1][away][np.argmax(hist[away])] + np.pi / 72

    def axis_vec(a):
        v = np.array([np.cos(a), np.sin(a)])
        proj = vecs @ v
        sel = np.abs(np.abs(proj) - step) < 0.35 * step
        if not sel.any():
            return v * step
        m = vecs[sel] * np.sign(proj[sel])[:, None]
        return m.mean(axis=0)

    e1 = axis_vec(a1)
    e2 = axis_vec(a2)
    if np.abs(e1[0] * e2[1] - e1[1] * e2[0]) < 0.3 * step * step:
        return None

    # annealed homography growth: start from an affine fit of the points
    # NEAREST the anchor (where the affine model is valid), then double
    # the included set by distance each round, refitting a homography —
    # a single global snap-and-refit can lock onto a sheared sublattice
    # under perspective foreshortening
    A = np.stack([e1, e2], axis=1)  # columns
    coords = np.linalg.solve(A, (pts - pts[aid]).T).T  # [n, 2] lattice units
    order = np.argsort(np.linalg.norm(pts - pts[aid], axis=1))
    m = 12
    H = None
    while True:
        sub = order[: min(m, n)]
        ij = np.round(coords[sub])
        res = np.linalg.norm(coords[sub] - ij, axis=1)
        ok = res < 0.25
        if ok.sum() < 6:
            return None
        H = _fit_homography(ij[ok], pts[sub][ok])
        if H is None:
            return None
        coords = _apply_h(np.linalg.inv(H), pts)
        if m >= n:
            break
        m *= 2
    # final polish on the full consistent set
    for _ in range(2):
        ij = np.round(coords)
        res = np.linalg.norm(coords - ij, axis=1)
        ok = res < 0.25
        if ok.sum() < 8:
            return None
        H = _fit_homography(ij[ok], pts[ok])
        if H is None:
            return None
        coords = _apply_h(np.linalg.inv(H), pts)
    ij = np.round(coords).astype(int)
    ok = np.linalg.norm(coords - ij, axis=1) < 0.3
    if ok.sum() < rows * cols:
        return None

    # choose the (cols x rows) integer window with max one-corner-per-cell
    iju = ij[ok]
    ptsu = pts[ok]
    best = None
    i0s = range(iju[:, 0].min(), iju[:, 0].max() - cols + 2)
    j0s = range(iju[:, 1].min(), iju[:, 1].max() - rows + 2)
    for i0 in i0s:
        for j0 in j0s:
            inside = (
                (iju[:, 0] >= i0) & (iju[:, 0] < i0 + cols)
                & (iju[:, 1] >= j0) & (iju[:, 1] < j0 + rows)
            )
            cells = {}
            for k in np.flatnonzero(inside):
                cells.setdefault((iju[k, 0] - i0, iju[k, 1] - j0), k)
            if best is None or len(cells) > best[0]:
                best = (len(cells), i0, j0, dict(cells))
    if best is None or best[0] < rows * cols:
        return None
    _, i0, j0, cells = best
    grid = np.zeros((rows, cols, 2), np.float32)
    for (ci, rj), k in cells.items():
        grid[rj, ci] = ptsu[k]
    return best[0], grid.reshape(rows * cols, 2)


def _fit_homography(src, dst):
    n = src.shape[0]
    A = []
    for k in range(n):
        x, y = src[k]
        u, v = dst[k]
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    A = np.asarray(A, np.float64)
    try:
        _, _, vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    H = vt[-1].reshape(3, 3)
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]


def _apply_h(H, pts):
    p = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def _canonicalize(grid: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Deterministic orientation: flip lattice axes so the first corner
    is the one closest to the image origin. Only flips — every lattice
    symmetry (flips, transpose) is an orthogonal affine map of the
    object plane, so any of them yields a valid Zhang homography; the
    flip just makes the output order reproducible. (A plain chessboard
    is orientation-ambiguous for the reference detector too.)"""
    g = grid.reshape(rows, cols, 2)
    corners = np.array(
        [g[0, 0], g[0, -1], g[-1, 0], g[-1, -1]]
    )
    first = int(np.argmin(corners[:, 0] + corners[:, 1]))
    if first == 1:
        g = g[:, ::-1]
    elif first == 2:
        g = g[::-1, :]
    elif first == 3:
        g = g[::-1, ::-1]
    return g.reshape(rows * cols, 2)


def find_chessboard_corners(
    img,
    pattern_size: tuple[int, int],  # (cols, rows) inner corners, cv order
    max_candidates: int = 256,
    refine: bool = True,
    device=None,
) -> np.ndarray | None:
    """cv::findChessboardCorners analog: [rows*cols, 2] pixel coordinates
    in deterministic row-major order, or None if the full grid could not
    be assembled. Detection and refinement run on the card unless
    `device="cpu"`; the lattice ordering on the host."""
    cols, rows = pattern_size
    img_t = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    xy, score, valid = (t.cpu().numpy() for t in saddle_corners(img_t, max_corners=max_candidates))
    pts = xy[valid]
    sc = score[valid]
    if pts.shape[0] < rows * cols:
        return None
    keep = _dedup(pts, sc, rows * cols)
    pts, sc = pts[keep], sc[keep]
    if pts.shape[0] < rows * cols:
        return None
    # inner X-corners respond ~3-4x stronger than the board's outer
    # L-corners: gating on the top-N median drops the border junk
    gate = 0.35 * float(np.median(np.sort(sc)[::-1][: rows * cols]))
    pts = pts[sc >= gate]
    if pts.shape[0] < rows * cols:
        return None
    grid = _order_grid(pts, rows, cols)
    if grid is None:
        # retry with both orientations of the pattern
        grid = _order_grid(pts, cols, rows)
        if grid is None:
            return None
        grid = grid.reshape(cols, rows, 2).transpose(1, 0, 2).reshape(-1, 2)
    grid = _canonicalize(grid, rows, cols)
    if refine:
        grid = corner_subpix(img_t, torch.from_numpy(np.ascontiguousarray(grid)).to(img_t.device))
        grid = grid.cpu().numpy()
    return grid


# --------------------------------------------------- circles grid ---


def median(img: torch.Tensor) -> torch.Tensor:
    """jnp.median: the midpoint of the two middle values of the sorted
    flattened array."""
    s = torch.sort(img.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def find_circles_grid(img, pattern_size: tuple[int, int], dark_circles: bool = True,
                      max_blobs: int = 128, device=None) -> tuple[np.ndarray, bool]:
    """Symmetric circles-grid detection (cv::findCirclesGrid analog):
    blob centroids at the median threshold on the card (unless
    `device="cpu"`), then host lattice ordering: the grid axes from the
    blob cloud's principal directions, every centre rounded to integer
    lattice coordinates. pattern_size = (cols, rows) of circle centres.
    Returns (centres [rows*cols, 2] row-major, ok)."""
    cols, rows = pattern_size
    want = cols * rows
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    blobs = detect_blobs(
        img, threshold=float(median(img)), dark_blobs=dark_circles,
        min_area=6.0, max_area=float(img.shape[0] * img.shape[1]) / want,
        max_blobs=max_blobs, device=img.device,
    )
    xy = blobs.xy.cpu().numpy()[blobs.valid.cpu().numpy()]
    if len(xy) < want:
        return np.zeros((want, 2), np.float32), False

    # keep the `want` largest blobs (already sorted by area by top-k)
    xy = xy[:want]
    c = xy.mean(0)
    d = xy - c
    # dominant axis via PCA; secondary = perpendicular component
    u, s, vt = np.linalg.svd(d, full_matrices=False)
    a1 = vt[0]  # long axis of the blob cloud
    a2 = vt[1]
    # grid coordinates: project, then infer step spacing from sorted gaps
    p1 = d @ a1
    p2 = d @ a2

    def lattice(p, n):
        order = np.sort(p)
        span = order[-1] - order[0]
        step = span / max(n - 1, 1)
        return np.round((p - order[0]) / max(step, 1e-9)).astype(int)

    # the long axis corresponds to max(cols, rows)
    n1, n2 = (cols, rows) if cols >= rows else (rows, cols)
    i1 = lattice(p1, n1)
    i2 = lattice(p2, n2)
    ok = (
        (i1 >= 0).all() and (i1 < n1).all()
        and (i2 >= 0).all() and (i2 < n2).all()
    )
    grid = np.full((n2, n1, 2), np.nan, np.float32)
    for k in range(want):
        grid[i2[k], i1[k]] = xy[k]
    ok = ok and not np.isnan(grid).any()
    if not ok:
        return np.zeros((want, 2), np.float32), False
    if cols < rows:  # transpose back to (rows, cols) row-major
        grid = grid.transpose(1, 0, 2)
    return grid.reshape(-1, 2), True
