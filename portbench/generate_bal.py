"""The generator of BAL-style bundle-adjustment problems: a photo
collection, cameras around a scene looking into it, each with its own
focal length and radial distortion (BAL's 9-parameter camera), as in
"Bundle Adjustment in the Large" (Agarwal, Snavely, Seitz, Szeliski, ECCV
2010). A configuration names the counts (cameras, points, observations of
a published problem), the image, the ranges of the intrinsics, the layout
and the noise. The scene (the cameras, their intrinsics, the points and
which camera sees which point) is drawn once from the configuration's
`scene_seed`, as a published problem's scene is fixed; `--seed` draws the
pixel noise and the start. Everything is drawn on `device`, with one
`torch.Generator` there for each, in float64, and handed over in the
program's types.

Points fill a ball about the origin, each on a surface facing out from
the centre. Each camera stands on a ring about the scene, at the distance
at which the ball fills a drawn share of its image's height at its focal
length (as a photograph frames its subject), at a drawn height; it looks
at a point drawn near the centre and is rolled a little about its axis.
BAL's camera looks down -z, so a point ahead of it has P.z < 0. Each
camera has a weight from a log-normal: its share of the observations is
uneven and heavy-tailed, as a photo collection's popular viewpoints are. A point of track length L is seen by L distinct cameras
on the side it faces, drawn by weight without replacement (the Gumbel
top-k trick). A point that falls outside any of its cameras' images, or
whose rays meet too nearly along one line to be triangulated (Bundler
keeps no such point), is drawn again with new cameras in the next round.
Observations are
BAL's pixels, pixel = f (1 + k1 |p|^2 + k2 |p|^4) p with p = -P.xy / P.z,
measured from the principal point, with pixel noise; they are listed
point by point.

Track lengths are one fixed multiset (generate.track_lengths) and the
cameras' weights the log-normal's quantiles. With the scene fixed, every
seed does the same work down to which camera sees which point, which sets
the contention of K6's global accumulator: on an H100 its pass time moved
by 3-8 % from scene to scene when the seed drew the scene. The start turns each
camera about its centre, moves the centre, scales the focal length and
sets k1 = k2 = 0, as Bundler starts a camera, and moves the points. No
camera is held constant, as Ceres's bundle_adjuster holds none.
"""

from __future__ import annotations

import math

import torch

from portbench.generate import track_lengths
from portbench.reference.ba_bal import Arith, rodrigues

CHUNK = 16384  # points whose cameras are drawn at once ([CHUNK, C] keys)


def rvec_of(R: torch.Tensor) -> torch.Tensor:
    """[C,3,3] rotations -> [C,3] axis-angle, through the unit quaternion
    (the largest of |w|, |x|, |y|, |z| taken as the pivot), angle in [0, pi]."""
    m = R
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    sq = torch.stack([1 + tr, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                      1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], 1)
    k = sq.argmax(1)
    piv = 0.5 * torch.sqrt(sq.gather(1, k[:, None]).clamp(min=0.0))[:, 0]
    d = 4.0 * piv
    a21, a02, a10 = m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1]
    s01, s02, s12 = m[:, 0, 1] + m[:, 1, 0], m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1]
    cand = torch.stack([
        torch.stack([piv, a21 / d, a02 / d, a10 / d], 1),
        torch.stack([a21 / d, piv, s01 / d, s02 / d], 1),
        torch.stack([a02 / d, s01 / d, piv, s12 / d], 1),
        torch.stack([a10 / d, s02 / d, s12 / d, piv], 1)], 1)
    q = cand[torch.arange(R.shape[0], device=R.device), k]
    q = torch.where(q[:, :1] < 0, -q, q)
    v = q[:, 1:]
    n = v.norm(dim=1, keepdim=True)
    angle = 2.0 * torch.atan2(n, q[:, :1])
    return torch.where(n > 1e-12, v * angle / n.clamp(min=1e-300), 2.0 * v)


def normal_quantiles(n: int) -> torch.Tensor:
    """The n quantiles (k + 0.5) / n of the standard normal, in float64."""
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)


def bal_pixels(R, t, intr, X):
    """BAL's projection, per observation: (pixel [O,2], P.z [O])."""
    pc = torch.einsum("oij,oj->oi", R, X) + t
    p = -pc[:, :2] / pc[:, 2:]
    s = (p * p).sum(1)
    f, k1, k2 = intr.unbind(1)
    return (f * (1.0 + s * (k1 + k2 * s)))[:, None] * p, pc[:, 2]


def make_problem(config: dict, traffic: dict, seed: int, device) -> dict:
    """The start problem (fields of the program's BAProblem, `cam_intr`
    among them) for traffic["problem"] of `config`, drawn from `seed` on
    `device`."""
    counts = config["problems"][traffic["problem"]]
    C, P, O = counts["cameras"], counts["points"], counts["observations"]
    img, lay, noise, intr_r = config["image"], config["layout"], config["noise"], config["intrinsics"]
    scene = torch.Generator(device=device)
    scene.manual_seed(config["scene_seed"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)

    def rand(*shape, gen=scene):
        return torch.rand(shape, generator=gen, **f64)

    def randn(*shape, gen=scene):
        return torch.randn(shape, generator=gen, **f64)

    def uniform(lo_hi, n):
        lo, hi = lo_hi
        return lo + (hi - lo) * rand(n)

    def in_ball(n, radius):
        d = randn(n, 3)
        return d / d.norm(dim=1, keepdim=True) * (radius * rand(n) ** (1.0 / 3.0))[:, None]

    L = torch.as_tensor(track_lengths(P, O, config["tracks"]["min_views"], C), device=device)
    L = L[torch.randperm(P, generator=scene, device=device)]
    obs_pt = torch.repeat_interleave(torch.arange(P, device=device), L)

    # cameras on a ring about the scene, each at the distance at which the
    # scene's image spans `frame_fill` of half the image's height at its
    # focal length, looking at a point near the centre
    intr = torch.stack([uniform(intr_r["focal_px"], C), uniform(intr_r["k1"], C), uniform(intr_r["k2"], C)], 1)
    half_angle = torch.atan(uniform(lay["frame_fill"], C) * (img["height"] / 2) / intr[:, 0])
    rho = lay["scene_radius"] / torch.sin(half_angle)
    az = 2 * math.pi * rand(C)
    centres = torch.stack([rho * torch.cos(az), uniform(lay["camera_height"], C), rho * torch.sin(az)], 1)
    ahead = in_ball(C, lay["aim_radius"]) - centres
    zc = -ahead / ahead.norm(dim=1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], **f64).expand(C, 3)
    xc = torch.linalg.cross(up, zc)
    xc = xc / xc.norm(dim=1, keepdim=True)
    yc = torch.linalg.cross(zc, xc)
    roll = lay["roll_rad"] * randn(C)
    c, s = torch.cos(roll), torch.sin(roll)
    R = torch.stack([c[:, None] * xc - s[:, None] * yc, s[:, None] * xc + c[:, None] * yc, zc], 1)
    rvec = rvec_of(R)
    ar = Arith()
    R = rodrigues(rvec, ar)
    tvec = -torch.einsum("cij,cj->ci", R, centres)

    # Each round, every point still to place is drawn in the ball, facing
    # out from the centre, and takes L distinct cameras by weight (Gumbel
    # top-k) among those on its side of the ring, within `view_deg` of its
    # facing; it is placed once every camera of its track sees it in its
    # image and two of its rays meet at `min_parallax_deg` to 180 degrees
    # less that (measured from its first camera's ray).
    logw = lay["camera_weight_sigma"] * normal_quantiles(C).to(device)[torch.randperm(C, generator=scene, device=device)]
    cos_view = math.cos(math.radians(lay["view_deg"]))
    cos_par = math.cos(math.radians(lay["min_parallax_deg"]))
    half = torch.tensor([img["width"] / 2 - img["margin_px"], img["height"] / 2 - img["margin_px"]], **f64)
    top = int(L.max())
    start = torch.cumsum(L, 0) - L
    cols = torch.arange(top, device=device)
    obs_cam = torch.zeros(O, dtype=torch.int64, device=device)
    pts = torch.zeros(P, 3, **f64)
    todo = torch.ones(P, dtype=torch.bool, device=device)
    for _ in range(lay["rounds"]):
        rows = todo.nonzero()[:, 0]
        pts[rows] = in_ball(rows.shape[0], lay["scene_radius"])
        facing = torch.atan2(pts[rows, 2], pts[rows, 0])
        for a in range(0, rows.shape[0], CHUNK):
            r = rows[a:a + CHUNK]
            keys = logw - torch.log(-torch.log(rand(r.shape[0], C).clamp(min=1e-300)))
            keys = keys.masked_fill(torch.cos(az[None, :] - facing[a:a + CHUNK, None]) < cos_view, -math.inf)
            take = cols[None, :] < L[r, None]
            obs_cam[(start[r, None] + cols[None, :])[take]] = keys.topk(top, dim=1).indices[take]
        pix, z = bal_pixels(R[obs_cam], tvec[obs_cam], intr[obs_cam], pts[obs_pt])
        seen = (z < -lay["near"]) & (pix.abs() <= half).all(1)
        ray = pts[obs_pt] - centres[obs_cam]
        ray = ray / ray.norm(dim=1, keepdim=True)
        cos_first = (ray * ray[start][obs_pt]).sum(1).abs()
        narrow = torch.ones(P, **f64).scatter_reduce_(0, obs_pt, cos_first, "amin") > cos_par
        todo = (torch.zeros(P, dtype=torch.int64, device=device).index_add_(0, obs_pt, (~seen).long()) > 0) | narrow
        if not bool(todo.any()):
            break
    if bool(todo.any()):
        raise ValueError(f"{int(todo.sum())} points found no place and cameras that see them")
    pix, _ = bal_pixels(R[obs_cam], tvec[obs_cam], intr[obs_cam], pts[obs_pt])
    uv = pix + noise["pixel_px"] * randn(O, 2, gen=g)

    # Bundler's start: each camera turned about and moved from its centre,
    # its focal length scaled and its distortion zero; points moved
    rvec0 = rvec + noise["start_rvec"] * randn(C, 3, gen=g)
    R0 = rodrigues(rvec0, ar)
    tvec0 = -torch.einsum("cij,cj->ci", R0, centres + noise["start_centre"] * randn(C, 3, gen=g))
    f0 = intr[:, 0] * (1.0 + noise["start_focal_rel"] * randn(C, gen=g))
    intr0 = torch.stack([f0, torch.zeros_like(f0), torch.zeros_like(f0)], 1)
    f32 = torch.float32
    return dict(
        cam_rvec=rvec0.to(f32),
        cam_tvec=tvec0.to(f32),
        cam_intr=intr0.to(f32),
        points=(pts + noise["start_points"] * randn(P, 3, gen=g)).to(f32),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv.to(f32),
        obs_valid=torch.ones(O, dtype=torch.bool, device=device),
        fixed_cams=torch.zeros(C, dtype=torch.bool, device=device))
