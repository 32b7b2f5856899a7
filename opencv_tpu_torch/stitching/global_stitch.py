"""Global (multi-image) panorama estimation and composition (port of
opencv_tpu/stitching/global_stitch.py): focal autocalibration, maximum
spanning tree rotation propagation, ray bundle adjustment, DP seams,
N-image composition.

Reference: stitching/src/autocalib.cpp (`focalsFromHomography`,
`estimateFocal`), motion_estimators.cpp (`HomographyBasedEstimator`,
`findMaxSpanningTree`, `BundleAdjusterRay`), seam_finders.cpp (DP seam),
stitcher.cpp (the pipeline).

The pose-graph bookkeeping (focal estimates, the tree, the rotation
propagation) is host numpy copied from the JAX package. ORB (kernel K1
on the card), matching, the pair RANSACs, the ray BA (levmarq with
forward-mode Jacobians), the warps, seams and blends run on the device.

RANSAC: the JAX function splits `PRNGKey(seed)` once per pair that
reaches its RANSAC (>= 8 matches), in pair order; torch cannot replay
those draws. Here one CPU generator seeded with `seed` draws each such
pair's subsets in the same order, or the caller injects them: `subsets`
is a sequence of [512, 4] index tensors, consumed one per RANSAC in pair
order.

The DP seam's forward pass is a row loop on the device; its choices are
read by the host once and backtracked there (exact: f32 adds and
comparisons only).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.config import MatchConfig, ORBConfig, RansacConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry import homography as hom
from opencv_tpu_torch.geometry.rotation import project_to_rotation, rodrigues
from opencv_tpu_torch.ops import matching, orb
from opencv_tpu_torch.optim.levmarq import levmarq
from opencv_tpu_torch.stitching import exposure
from opencv_tpu_torch.stitching.blend import multiband_blend

PANO_RANSAC = RansacConfig(n_hypotheses=512, threshold=3.0)


# ------------------------------------------------------------ autocalib ---

def focals_from_homography(H: np.ndarray) -> tuple[float | None, float | None]:
    """(f0, f1) estimates from a rotation-only homography H: x1 ~ H x0
    (autocalib.cpp focalsFromHomography). None where the discriminant
    goes negative (non-rotational H)."""
    h = np.asarray(H, np.float64).reshape(-1)

    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if abs(d1) > 1e-12 else -1.0
    v2 = (h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / d2 if abs(d2) > 1e-12 else -1.0
    f1 = None
    if v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if v1 > 0 and v2 > 0:
        f1 = math.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f1 = math.sqrt(v1)

    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
    v1 = -h[2] * h[5] / d1 if abs(d1) > 1e-12 else -1.0
    v2 = (h[5] * h[5] - h[2] * h[2]) / d2 if abs(d2) > 1e-12 else -1.0
    f0 = None
    if v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if v1 > 0 and v2 > 0:
        f0 = math.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f0 = math.sqrt(v1)
    return f0, f1


def estimate_focal(homographies: dict[tuple[int, int], np.ndarray],
                   shapes: list[tuple[int, int]]) -> float:
    """Median focal over all pairwise estimates (autocalib.cpp
    estimateFocal); w + h when no pair yields one. Homographies must be
    centred (principal point at the image centre)."""
    ests = []
    for H in homographies.values():
        f0, f1 = focals_from_homography(H)
        if f0 is not None and f1 is not None:
            ests.append(math.sqrt(f0 * f1))
    if ests:
        return float(np.median(ests))
    h, w = shapes[0]
    return float(w + h)


# ---------------------------------------------- rotation initialization ---

def max_spanning_tree(n: int, edges: list[tuple[int, int]],
                      conf: list[float]) -> list[tuple[int, int]]:
    """Prim maximum spanning tree; (parent, child) edges in the order they
    join, from the highest-degree node (findMaxSpanningTree analog)."""
    adj: dict[int, list[tuple[float, int]]] = {i: [] for i in range(n)}
    for (i, j), c in zip(edges, conf):
        adj[i].append((c, j))
        adj[j].append((c, i))
    root = max(range(n), key=lambda i: len(adj[i]))
    in_tree = {root}
    out: list[tuple[int, int]] = []
    while len(in_tree) < n:
        best = None
        for i in in_tree:
            for c, j in adj[i]:
                if j not in in_tree and (best is None or c > best[0]):
                    best = (c, i, j)
        if best is None:
            raise ValueError("match graph is disconnected")
        _, i, j = best
        in_tree.add(j)
        out.append((i, j))
    return out


def propagate_rotations(n: int, homographies: dict[tuple[int, int], np.ndarray],
                        tree: list[tuple[int, int]], f: float) -> np.ndarray:
    """R_i per image from centred pairwise homographies H_ij (x_j ~ H x_i)
    over the tree: R_j = proj_SO3(K^-1 H_ij K) @ R_i, the root at the
    identity (HomographyBasedEstimator, motion_estimators.cpp:60). The
    projection is the port's (its own algorithm: agrees with the JAX
    package's to a tolerance)."""
    K = np.diag([f, f, 1.0])
    Kinv = np.diag([1.0 / f, 1.0 / f, 1.0])
    R = [np.eye(3) for _ in range(n)]
    for i, j in tree:
        if (i, j) in homographies:
            rel = Kinv @ homographies[(i, j)] @ K
        else:
            rel = np.linalg.inv(Kinv @ homographies[(j, i)] @ K)
        rel = project_to_rotation(torch.as_tensor(rel, dtype=torch.float32)).numpy()
        R[j] = rel @ R[i]
    return np.stack(R)


# ------------------------------------------------------------- ray BA ---

def refine_rotations_ba(R0: np.ndarray, f0: float, pair_pts: list, iters: int = 20,
                        device=None) -> tuple[np.ndarray, float]:
    """Bundle-adjust rotations and a shared focal on ray agreement
    (BundleAdjusterRay: 3 residuals per match, the unit-ray difference
    times f). pair_pts: (i, j, xy_i [M, 2] centred px, xy_j [M, 2], w [M]
    0/1). Runs on the card unless `device="cpu"`. Returns (R [N, 3, 3], f)."""
    dev = resolve_device(device)
    n = R0.shape[0]
    i_idx = torch.as_tensor(np.array([p[0] for p in pair_pts]), device=dev)
    j_idx = torch.as_tensor(np.array([p[1] for p in pair_pts]), device=dev)

    def stack(k):
        return torch.as_tensor(np.stack([p[k] for p in pair_pts]), dtype=torch.float32, device=dev)

    xi, xj, wm = stack(2), stack(3), stack(4)  # [E, M, 2], [E, M, 2], [E, M]
    R0t = torch.as_tensor(R0, dtype=torch.float32, device=dev)
    x0 = torch.zeros(n * 3 + 1, dtype=torch.float32, device=dev)
    x0[-1] = float(np.log(np.float32(f0)))

    def rays(xy, R, f):
        p = torch.cat([xy / f, torch.ones_like(xy[..., :1])], -1)  # K^-1 x
        r = p @ R  # R^T applied to rows: camera ray -> world ray
        return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)

    def residual(params):
        f = torch.exp(params[-1])
        Rs = rodrigues(params[:-1].reshape(n, 3)) @ R0t  # [N, 3, 3]
        ri = rays(xi, Rs[i_idx], f)
        rj = rays(xj, Rs[j_idx], f)
        # f * diff ~ arc length in pixels (the reference's `mult`): the raw
        # unit-ray difference has a bogus optimum at f = inf
        return (f * (ri - rj) * wm[..., None]).reshape(-1)

    params = levmarq(residual, x0, iters=iters).params.cpu()
    f = float(torch.exp(params[-1]))
    dr = params[:-1].reshape(n, 3)
    R = np.stack([rodrigues(dr[k]).numpy() @ R0[k] for k in range(n)])
    return R, f


# ------------------------------------------------------------- DP seam ---

def dp_seam(cost: torch.Tensor) -> torch.Tensor:
    """Minimal vertical seam through a cost image [H, W] (DpSeamFinder
    analog): the per-row seam column, i32 [H]. The forward pass runs row by
    row on the device over a buffer bordered by 1e9, so the left and right
    neighbours are views; each row takes the first of tied minima (left,
    then middle, then right), as argmin does. The two comparisons that
    decide it are read back once, and the host backtracks."""
    h, w = cost.shape
    buf = torch.full((w + 2,), 1e9, dtype=torch.float32, device=cost.device)
    buf[1:-1] = cost[0]
    left, prev, right = buf[:-2], buf[1:-1], buf[2:]
    rows = []
    for k in range(1, h):
        take_left = (left <= prev) & (left <= right)
        rows.append(torch.stack([take_left, prev <= right]))
        prev.copy_(cost[k] + torch.where(take_left, left, torch.minimum(prev, right)))
    last = prev.cpu().numpy()
    ch = torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 2, w), bool)
    seam = np.empty(h, np.int32)
    x = int(np.argmin(last))
    seam[h - 1] = x
    for k in range(h - 2, -1, -1):
        take_left, mid_le_right = ch[k, :, x]
        x += -1 if take_left else (0 if mid_le_right else 1)
        seam[k] = x
    return torch.from_numpy(seam).to(cost.device)


def seam_masks(img0: torch.Tensor, m0: torch.Tensor, img1: torch.Tensor,
               m1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split an overlap with a DP seam: pixels left of the seam keep img0,
    right of it img1 (non-overlap regions keep their owner)."""
    overlap = m0 & m1
    cost = torch.where(overlap, (img0 - img1).abs(), 1e4)
    seam = dp_seam(cost)
    xx = torch.arange(img0.shape[1], device=img0.device)[None, :]
    left_of = xx < seam[:, None]
    return m0 & (~overlap | left_of), m1 & (~overlap | ~left_of)


# ------------------------------------------------------------ pipeline ---

def _spherical_warp_rot(img: torch.Tensor, f: float, R: np.ndarray, canvas: tuple[int, int],
                        scale: float, theta0: float, phi0: float):
    """Warp one image onto the shared equirectangular canvas given its
    rotation (world ray -> camera ray = R @ s). Returns (warped, mask).
    The rotation is applied as three explicit products per component
    (the JAX function's [H, W, 3] @ R^T; its sums agree to a tolerance)."""
    h, w = img.shape
    out_h, out_w = canvas
    dev = img.device
    sc = torch.tensor(scale, dtype=torch.float32, device=dev)
    theta = theta0 + torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] / sc
    phi = phi0 + torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] / sc
    s = (torch.sin(theta) * torch.cos(phi), torch.sin(phi) * torch.ones_like(theta),
         torch.cos(theta) * torch.cos(phi))
    Rf = np.asarray(R, np.float32)
    cam = [s[0] * float(Rf[k, 0]) + s[1] * float(Rf[k, 1]) + s[2] * float(Rf[k, 2])
           for k in range(3)]
    z = cam[2]
    zc = z.clamp(min=1e-6)
    x = f * cam[0] / zc + w / 2.0
    y = f * cam[1] / zc + h / 2.0
    valid = (z > 1e-6) & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    out = torch.where(valid, imgproc.bilinear_sample(img, torch.stack([x, y], -1)), 0.0)
    return out, valid


def estimate_panorama(images, n_features: int = 800, conf_threshold: float = 1.0, seed: int = 0,
                      ba_iters: int = 20, match_cap: int = 256, subsets=None, device=None):
    """Feature-match all pairs, autocalibrate the focal, propagate
    rotations over the maximum spanning tree, bundle-adjust
    (estimateTransform analog). `subsets`: see the module docstring.
    Runs on the card unless `device="cpu"`. Returns (R [N, 3, 3], f, pair
    diagnostics)."""
    dev = resolve_device(device)
    imgs = [torch.as_tensor(im, device=dev).to(torch.float32) for im in images]
    n = len(imgs)
    cfg = ORBConfig(n_features=n_features, n_levels=4)
    feats = [orb.detect_and_compute(im, cfg) for im in imgs]
    gen = torch.Generator()
    gen.manual_seed(seed)
    injected = iter(subsets) if subsets is not None else None

    homographies: dict[tuple[int, int], np.ndarray] = {}
    edges, confs, pair_pts = [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            (kpi, di), (kpj, dj) = feats[i], feats[j]
            m = matching.knn_match(di, dj, query_valid=kpi.valid, train_valid=kpj.valid,
                                   config=MatchConfig())
            n_matches = int(m.valid.sum())
            if n_matches < 8:
                continue
            xi = kpi.xy[m.query_idx]
            xj = kpj.xy[m.train_idx]
            res = hom.find_homography_ransac(  # x_j ~ H x_i
                gen, xi, xj, valid=m.valid, cfg=PANO_RANSAC,
                subsets=None if injected is None else next(injected))
            n_inl = int(res.n_inliers)
            conf = n_inl / (8.0 + 0.3 * n_matches)  # matchers.cpp formula
            if conf < conf_threshold or not bool(res.ok):
                continue
            hi, wi = imgs[i].shape
            hj, wj = imgs[j].shape
            Ti = np.array([[1, 0, -wi / 2.0], [0, 1, -hi / 2.0], [0, 0, 1]])
            Tj = np.array([[1, 0, -wj / 2.0], [0, 1, -hj / 2.0], [0, 0, 1]])
            Hc = Tj @ res.model.cpu().double().numpy() @ np.linalg.inv(Ti)
            homographies[(i, j)] = Hc / Hc[2, 2]
            edges.append((i, j))
            confs.append(conf)
            # centred match points for BA (fixed cap, mask-padded)
            inl = (res.inliers & m.valid).cpu().numpy()
            qi = xi.cpu().numpy()[:, :2] - [wi / 2.0, hi / 2.0]
            tj = xj.cpu().numpy()[:, :2] - [wj / 2.0, hj / 2.0]
            sel = np.where(inl)[0][:match_cap]
            pi = np.zeros((match_cap, 2), np.float32)
            pj = np.zeros((match_cap, 2), np.float32)
            wmask = np.zeros((match_cap,), np.float32)
            pi[: len(sel)] = qi[sel]
            pj[: len(sel)] = tj[sel]
            wmask[: len(sel)] = 1.0
            pair_pts.append((i, j, pi, pj, wmask))

    if not edges:
        raise ValueError("no confident image pairs")
    f = estimate_focal(homographies, [tuple(im.shape) for im in imgs])
    tree = max_spanning_tree(n, edges, confs)
    R0 = propagate_rotations(n, homographies, tree, f)
    R, f = refine_rotations_ba(R0, f, pair_pts, iters=ba_iters, device=dev)
    return R, f, {"edges": edges, "conf": confs, "tree": tree, "pair_pts": pair_pts,
                  "homographies": homographies}


def canvas_geometry(shapes: list[tuple[int, int]], R: np.ndarray, f: float):
    """The equirectangular canvas covering every image's corner rays:
    ((out_h, out_w), scale, theta0, phi0)."""
    thetas, phis = [], []
    for k, (h, w) in enumerate(shapes):
        corners = np.array([[-w / 2, -h / 2, 1], [w / 2, -h / 2, 1], [-w / 2, h / 2, 1],
                            [w / 2, h / 2, 1], [0, 0, 1]], np.float64)
        rays = (np.diag([1 / f, 1 / f, 1.0]) @ corners.T).T
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        world = rays @ R[k]  # R^T ray
        thetas += list(np.arctan2(world[:, 0], world[:, 2]))
        phis += list(np.arcsin(np.clip(world[:, 1], -1, 1)))
    scale = f  # px per radian
    margin = 8.0 / scale
    theta0, theta1 = min(thetas) - margin, max(thetas) + margin
    phi0, phi1 = min(phis) - margin, max(phis) + margin
    canvas = (int(np.ceil((phi1 - phi0) * scale)), int(np.ceil((theta1 - theta0) * scale)))
    return canvas, scale, theta0, phi0


def compose_panorama(images: list[torch.Tensor], R: np.ndarray, f: float, use_seams: bool = True,
                     blend_bands: int = 3, exposure_comp: str | None = "gain") -> torch.Tensor:
    """Warp every image onto the spherical canvas, compensate exposure
    ("gain" | "blocks" | None), cut DP seams between overlapping pairs (one
    host read per pair), multiband-blend. Returns the canvas on the
    images' device."""
    n = len(images)
    canvas, scale, theta0, phi0 = canvas_geometry([tuple(im.shape) for im in images], R, f)
    warped, masks = [], []
    for k, im in enumerate(images):
        wimg, m = _spherical_warp_rot(im, f, R[k], canvas, scale, theta0, phi0)
        warped.append(wimg)
        masks.append(m)
    if exposure_comp == "gain":
        warped, _ = exposure.gain_compensate(warped, masks)
    elif exposure_comp == "blocks":
        warped, _ = exposure.block_gain_compensate(warped, masks)
    if use_seams:
        for a in range(n):
            for b in range(a + 1, n):
                if bool((masks[a] & masks[b]).any()):
                    masks[a], masks[b] = seam_masks(warped[a], masks[a], warped[b], masks[b])
    out = multiband_blend(warped, masks, n_bands=blend_bands)
    any_mask = masks[0]
    for m in masks[1:]:
        any_mask = any_mask | m
    return torch.where(any_mask, out, 0.0)


def stitch_panorama(images, n_features: int = 800, seed: int = 0, use_seams: bool = True,
                    blend_bands: int = 3, exposure_comp: str | None = "gain", subsets=None,
                    device=None) -> np.ndarray:
    """The N-image pipeline (Stitcher::stitch analog): estimate_panorama,
    then compose_panorama. Runs on the card unless `device="cpu"`.
    Returns the panorama as numpy f32."""
    dev = resolve_device(device)
    imgs = [torch.as_tensor(im, device=dev).to(torch.float32) for im in images]
    R, f, _ = estimate_panorama(imgs, n_features=n_features, seed=seed, subsets=subsets,
                                device=dev)
    return compose_panorama(imgs, R, f, use_seams, blend_bands, exposure_comp).cpu().numpy()
