"""The one generator of the benchmark's bundle-adjustment problems: a
calibrated monocular camera driving forward around a closed loop of road,
as in a KITTI odometry sequence, mapped once the loop has closed.

A configuration file names a deployment: its problems (camera, point and
observation counts), the camera's calibration, how the path and the map
are laid out, and the noise. A traffic file names the problem. Everything
is drawn on `device` from `--seed`, with one `torch.Generator` there, in
float64, and handed over in the program's types.

Cameras sit `spacing` apart on a circle whose length is the path's, each
looking along the road (x right, y down, z forward: KITTI's and OpenCV's
camera frame), each turned by a small random rotation; the world frame is
the first camera's. A point is seen by a run of consecutive cameras,
which wraps past the last camera to the first where the loop closes. It
lies in the image of the run's last (nearest) camera, at a depth from it
between `near` and `far` such that its distance shrinks over the run by
at most `scale_range` (the range over which an ORB feature is matched
across its pyramid), where every camera of the run sees it in its image,
and where the rays from the run's first and last cameras meet at
`min_parallax_deg` or more (ORB-SLAM2 triangulates no point with less):
a point that misses any of these is drawn again. Observations are
normalized image coordinates ((u - cx) / fx, (v - cy) / fy), with pixel
noise.

Track lengths are one fixed multiset per problem (seed-independent, so
every seed does the same amount of work): at least `min_views`, an
exponential tail, summing to the observation count exactly. The seed
decides which point gets which length, where its run starts, and all
positions and noise. Observations are listed point by point.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.ba_lm import Arith, rodrigues


def track_lengths(n_points: int, n_obs: int, min_views: int, max_views: int) -> np.ndarray:
    """Sorted track lengths, each in [min_views, max_views], summing to
    n_obs: min_views + the rounded quantiles of an exponential of mean
    n_obs/n_points - min_views, then one view added to (or taken from) the
    longest tracks that can take it until the sum is exact."""
    if not min_views * n_points <= n_obs <= max_views * n_points:
        raise ValueError(f"{n_obs} observations do not fit {n_points} tracks of {min_views}..{max_views}")
    mu = n_obs / n_points - min_views
    u = (np.arange(n_points) + 0.5) / n_points
    L = np.minimum(min_views + np.round(-mu * np.log1p(-u)).astype(np.int64), max_views)
    longest_first = np.arange(n_points)[::-1]
    d = int(n_obs - L.sum())
    while d:
        step = 1 if d > 0 else -1
        room = L[longest_first] < max_views if d > 0 else L[longest_first] > min_views
        cand = longest_first[room][:abs(d)]
        L[cand] += step
        d -= step * len(cand)
    return np.sort(L)


def max_views(config: dict, n_cams: int) -> int:
    """The longest run of cameras that one point can span: its distance
    shrinks by `scale_range` at most, from no farther than `far`, and the
    camera turns by no more than `max_turn` radians along the run."""
    lay = config["layout"]
    span = lay["far"] * (1.0 - 1.0 / lay["scale_range"])
    return min(n_cams, 1 + math.floor(span / lay["spacing"]),
               1 + math.floor(lay["max_turn"] * n_cams / (2 * math.pi)))


def make_problem(config: dict, traffic: dict, seed: int, device) -> dict:
    """The start problem (fields of the program's BAProblem) for
    traffic["problem"] of `config`, drawn from `seed` on `device`."""
    counts = config["problems"][traffic["problem"]]
    C, P, O = counts["cameras"], counts["points"], counts["observations"]
    cam, lay, noise = config["camera"], config["layout"], config["noise"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f64)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f64)

    L = torch.as_tensor(track_lengths(P, O, lay["min_views"], max_views(config, C)), device=device)
    L = L[torch.randperm(P, generator=g, device=device)]
    obs_pt = torch.repeat_interleave(torch.arange(P, device=device), L)
    start = torch.cumsum(L, 0) - L
    first = torch.floor(rand(P) * C).long()
    last = (first + L - 1) % C
    obs_cam = (first[obs_pt] + torch.arange(O, device=device) - start[obs_pt]) % C

    # Camera k sits at angle phi = 2 pi k / C on a circle of the path's
    # length through the origin, turning towards +x: camera-to-world
    # rotation R_y(phi), world-to-camera R_y(-phi), times a small turn.
    s = lay["spacing"]
    radius = C * s / (2 * math.pi)
    phi = 2 * math.pi * torch.arange(C, **f64) / C
    zero = torch.zeros(C, **f64)
    centres = torch.stack([radius * (1 - torch.cos(phi)), zero, radius * torch.sin(phi)], 1)
    wrapped = torch.where(phi > math.pi, phi - 2 * math.pi, phi)
    rvec = torch.stack([zero, -wrapped, zero], 1) + noise["true_rvec"] * randn(C, 3)
    ar = Arith()

    def world_to_camera(rv, ctr):
        R = rodrigues(rv, ar)
        return R, -torch.einsum("cij,cj->ci", R, ctr)

    R, tvec = world_to_camera(rvec, centres)

    # A point's depth from the nearest camera of its run, d, lies in
    # [max(near, span / (scale_range - 1)), far - span], and no farther
    # than the depth at which the run's baseline, seen at the point's angle
    # off the optical axis, subtends the least parallax. A point that some
    # camera of its run does not see, or that misses a bound once placed,
    # is drawn again in the next round.
    span = s * (L - 1).to(torch.float64)
    lo = torch.clamp(span / (lay["scale_range"] - 1.0), min=lay["near"])
    m = lay["margin"]
    u_lo, u_hi = -cam["cx"] / cam["fx"] + m, (cam["width"] - cam["cx"]) / cam["fx"] - m
    v_lo, v_hi = -cam["cy"] / cam["fy"] + m, (cam["height"] - cam["cy"]) / cam["fy"] - m
    cos_par = math.cos(math.radians(lay["min_parallax_deg"]))
    pts = torch.zeros(P, 3, **f64)
    todo = torch.ones(P, dtype=torch.bool, device=device)
    for _ in range(lay["rounds"]):
        u = u_lo + (u_hi - u_lo) * rand(P)
        v = v_lo + (v_hi - v_lo) * rand(P)
        off_axis = torch.sqrt((u * u + v * v) / (1.0 + u * u + v * v))
        hi = torch.minimum(lay["far"] - span, span * off_axis / math.radians(lay["min_parallax_deg"]))
        d = lo + (hi - lo).clamp(min=0.0) * rand(P)
        ahead = torch.stack([u * d, v * d, d], 1)
        drawn = torch.einsum("pji,pj->pi", R[last], ahead - tvec[last])
        pts = torch.where(todo[:, None], drawn, pts)
        pc = torch.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt]) + tvec[obs_cam]
        z = pc[:, 2]
        uv = pc[:, :2] / z[:, None]
        seen = ((z > 1.0) & (uv[:, 0] >= u_lo) & (uv[:, 0] <= u_hi) & (uv[:, 1] >= v_lo) & (uv[:, 1] <= v_hi))
        ray = pts[obs_pt] - centres[obs_cam]
        dist = ray.norm(dim=1)
        far_ = torch.zeros(P, **f64).scatter_reduce_(0, obs_pt, dist, "amax", include_self=False)
        near_ = torch.zeros(P, **f64).scatter_reduce_(0, obs_pt, dist, "amin", include_self=False)
        unseen = torch.zeros(P, dtype=torch.int64, device=device).index_add_(0, obs_pt, (~seen).long())
        end = start + L - 1
        cos_run = (ray[start] * ray[end]).sum(1) / (dist[start] * dist[end])
        todo = (unseen > 0) | (far_ > lay["scale_range"] * near_) | (cos_run >= cos_par)
        if not bool(todo.any()):
            break
    if bool(todo.any()):
        raise ValueError(f"{int(todo.sum())} points found no place that every camera of their run sees")
    pc = torch.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt]) + tvec[obs_cam]
    px = torch.tensor([noise["pixel_px"] / cam["fx"], noise["pixel_px"] / cam["fy"]], **f64)
    uv = pc[:, :2] / pc[:, 2:] + px * randn(O, 2)
    # The start turns each free camera about its own centre and moves the
    # centre, so the error of a pose does not grow with its distance from
    # the world origin.
    fixed = torch.arange(C, device=device) < config["fixed_cameras"]
    free = (~fixed)[:, None].to(torch.float64)
    rvec0 = rvec + free * noise["start_rvec"] * randn(C, 3)
    _, tvec0 = world_to_camera(rvec0, centres + free * noise["start_centre"] * randn(C, 3))
    f32 = torch.float32
    return dict(
        cam_rvec=rvec0.to(f32),
        cam_tvec=tvec0.to(f32),
        points=(pts + noise["start_points"] * randn(P, 3)).to(f32),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv.to(f32),
        obs_valid=torch.ones(O, dtype=torch.bool, device=device), fixed_cams=fixed)
