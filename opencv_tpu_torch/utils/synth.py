"""Real-imagery sequence synthesis (port of opencv_tpu/utils/synth.py,
host numpy; the rotation and the splat blur are the port's functions on
CPU tensors): render a camera trajectory through a
piecewise-planar scene textured with real photographs.

Role: ground-truth-bearing test/benchmark data for the VO engine when no
odometry dataset is shippable. The reference does the same thing for
calibration (synthetic chessboards rendered at known poses,
calib3d/test/test_chessboardgenerator.cpp) — here the rendered content is
real image texture, so the front-end (FAST/ORB/LK statistics, descriptor
distinctiveness) sees real-world gradients rather than procedural noise.

Scene model: N textured planes z = const (world frame), nearest-hit
ray-cast per pixel, bilinear texture sampling. Exact per-pixel geometry
means exact ground truth for ATE scoring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _rotation(rvec) -> np.ndarray:
    """f32 [3, 3] rotation of an axis-angle vector (the port's rodrigues on
    the CPU)."""
    from opencv_tpu_torch.geometry.rotation import rodrigues

    return rodrigues(torch.as_tensor(np.asarray(rvec, np.float32))).numpy()


@dataclasses.dataclass(frozen=True)
class TexturedPlane:
    """Axis-aligned textured plane z=z0 spanning [x0,x1]x[y0,y1] (world).

    tex_origin/tex_scale map world (x,y) to texture pixels:
    tex_uv = (world_xy - (x0,y0)) * tex_scale + tex_origin."""

    z0: float
    x0: float
    x1: float
    y0: float
    y1: float
    tex: np.ndarray  # [th, tw] f32 grayscale
    tex_origin: tuple[float, float] = (0.0, 0.0)
    tex_scale: float = 60.0  # texture px per world unit


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    th, tw = tex.shape
    u = np.clip(u, 0.0, tw - 1.001)
    v = np.clip(v, 0.0, th - 1.001)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    au = u - u0
    av = v - v0
    return (
        tex[v0, u0] * (1 - au) * (1 - av)
        + tex[v0, u0 + 1] * au * (1 - av)
        + tex[v0 + 1, u0] * (1 - au) * av
        + tex[v0 + 1, u0 + 1] * au * av
    )


@dataclasses.dataclass(frozen=True)
class OrientedPlane:
    """Finite textured rectangle with arbitrary orientation: center +
    two in-plane axes (e.g. the walls of a closed room/prism for loop-
    closure scenes, which z=const TexturedPlane cannot express)."""

    origin: np.ndarray  # [3] rectangle center (world)
    ax_u: np.ndarray  # [3] unit in-plane axis, horizontal texture dir
    ax_v: np.ndarray  # [3] unit in-plane axis, vertical texture dir
    half_u: float
    half_v: float
    tex: np.ndarray  # [th, tw] f32 grayscale


def _raycast(p, C: np.ndarray, rays_w: np.ndarray):
    """(s, tu, tv, inside) of ray C + s*rays_w against plane `p`."""
    if isinstance(p, TexturedPlane):
        dz = rays_w[..., 2]
        safe_dz = np.where(np.abs(dz) < 1e-12, 1e-12, dz)
        s = (p.z0 - C[2]) / safe_dz
        x = C[0] + s * rays_w[..., 0]
        y = C[1] + s * rays_w[..., 1]
        inside = (x >= p.x0) & (x <= p.x1) & (y >= p.y0) & (y <= p.y1)
        tu = (x - p.x0) * p.tex_scale + p.tex_origin[0]
        tv = (y - p.y0) * p.tex_scale + p.tex_origin[1]
        return s, tu, tv, inside
    n = np.cross(p.ax_u, p.ax_v)
    dn = rays_w @ n
    safe_dn = np.where(np.abs(dn) < 1e-12, 1e-12, dn)
    s = (p.origin - C) @ n / safe_dn
    hit = C + s[..., None] * rays_w - p.origin  # [h,w,3]
    u = hit @ p.ax_u
    v = hit @ p.ax_v
    inside = (np.abs(u) <= p.half_u) & (np.abs(v) <= p.half_v)
    th, tw = p.tex.shape
    tu = (u + p.half_u) * (tw - 2) / (2 * p.half_u)
    tv = (v + p.half_v) * (th - 2) / (2 * p.half_v)
    return s, tu, tv, inside


def render_frame(
    planes: list,
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    h: int,
    w: int,
    background: float = 8.0,
    return_depth: bool = False,
):
    """Ray-cast one frame at world->camera pose (R, t). Returns [h,w] f32;
    with return_depth also the per-pixel camera-frame depth z (= the ray
    parameter s, since rays are (u,v,1) in camera coords; inf = no hit) —
    exact ground truth for stereo disparity tests (gt_disp = f·b/z)."""
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    rays_cam = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ Kinv.T  # [h,w,3]
    C = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)  # camera center
    rays_w = rays_cam @ np.asarray(R, np.float64)  # R^T d

    img = np.full((h, w), background, np.float64)
    best_s = np.full((h, w), np.inf)
    for p in planes:
        s, tu, tv, inside = _raycast(p, C, rays_w)
        hit = (s > 0.05) & (s < best_s) & inside
        vals = _bilinear(p.tex, tu, tv)
        img = np.where(hit, vals, img)
        best_s = np.where(hit, s, best_s)
    if return_depth:
        return img.astype(np.float32), best_s.astype(np.float32)
    return img.astype(np.float32)


def splat_frame(
    world_pts: np.ndarray,
    intensities: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    K: np.ndarray,
    h: int,
    w: int,
    blur_sigma: float = 1.1,
    gain: float = 4.0,
) -> np.ndarray:
    """Project world points at pose (rvec, tvec) and splat blurred point
    sprites — the cheap parallax-exact renderer for unbounded (non-planar)
    scene shapes like loop trajectories. Bilinear subpixel splatting:
    integer splats would quantize the scene geometry itself and swamp
    small-parallax signal with 0.5 px noise."""
    from opencv_tpu_torch.core import imgproc

    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    R = _rotation(rvec)
    pc = world_pts @ R.T + tvec
    z = pc[:, 2]
    vis = z > 0.5
    u = fx * pc[:, 0] / np.where(vis, z, 1.0) + cx
    v = fy * pc[:, 1] / np.where(vis, z, 1.0) + cy
    vis &= (u >= 2) & (u < w - 2) & (v >= 2) & (v < h - 2)
    img = np.zeros((h, w), np.float32)
    uf, vf = u[vis], v[vis]
    u0 = np.floor(uf).astype(int)
    v0 = np.floor(vf).astype(int)
    au, av = uf - u0, vf - v0
    ii = intensities[vis]
    np.add.at(img, (v0, u0), ii * (1 - au) * (1 - av))
    np.add.at(img, (v0, u0 + 1), ii * au * (1 - av))
    np.add.at(img, (v0 + 1, u0), ii * (1 - au) * av)
    np.add.at(img, (v0 + 1, u0 + 1), ii * au * av)
    img = imgproc.gaussian_blur(torch.from_numpy(img), 5, blur_sigma).numpy()
    return np.clip(img * gain, 0, 255)


def two_plane_scene(
    texture: np.ndarray,
    texture_near: np.ndarray | None = None,
    depth_far: float = 9.0,
    depth_near: float = 5.5,
):
    """A background wall plus a foreground slab. Prefer two DIFFERENT
    real textures — repetitive single-texture scenes destroy descriptor
    distinctiveness, exactly as in real life."""
    th, tw = texture.shape
    if texture_near is None:
        texture_near = texture
    nh, nw = texture_near.shape
    far = TexturedPlane(
        z0=depth_far, x0=-9.0, x1=9.0, y0=-6.5, y1=6.5,
        tex=texture, tex_origin=(0.0, 0.0),
        tex_scale=min((tw - 2) / 18.0, (th - 2) / 13.0),
    )
    near = TexturedPlane(
        z0=depth_near, x0=-1.8, x1=2.6, y0=-2.4, y1=1.4,
        tex=texture_near, tex_origin=(nw * 0.05, nh * 0.05),
        tex_scale=min((nw - 2) / 5.0, (nh - 2) / 4.3),
    )
    return [far, near]


def dolly_trajectory(
    n_frames: int,
    step_x: float = 0.09,
    step_z: float = 0.03,
    yaw_per_frame_deg: float = 0.25,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Lateral dolly with slow yaw: (rvec, tvec) world->camera per frame.
    Generates bootstrap parallax immediately (translation-dominant)."""
    poses = []
    for i in range(n_frames):
        yaw = np.deg2rad(yaw_per_frame_deg) * i
        rvec = np.array([0.0, yaw, 0.0], np.float32)
        R = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        center = np.array([step_x * i, 0.015 * np.sin(0.4 * i), step_z * i])
        t = (-R @ center).astype(np.float32)
        poses.append((rvec, t))
    return poses


def render_sequence(
    texture: np.ndarray,
    K: np.ndarray,
    h: int,
    w: int,
    n_frames: int = 30,
    planes: list[TexturedPlane] | None = None,
    trajectory: list[tuple[np.ndarray, np.ndarray]] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Render frames + ground-truth camera centers.

    Returns (frames [F,h,w] f32, gt_centers [F,3] f64)."""
    if planes is None:
        planes = two_plane_scene(texture)
    if trajectory is None:
        trajectory = dolly_trajectory(n_frames)
    frames = []
    centers = []
    for rvec, tvec in trajectory[:n_frames]:
        R = _rotation(rvec).astype(np.float64)
        frames.append(render_frame(planes, K, R, tvec, h, w))
        centers.append(-R.T @ np.asarray(tvec, np.float64))
    return np.stack(frames), np.stack(centers)


def prism_scene(
    textures: list[np.ndarray],
    n_walls: int = 12,
    radius: float = 10.0,
    half_height: float = 5.0,
) -> list[OrientedPlane]:
    """Closed textured prism (inward-facing walls): the canonical loop-
    closure scene. Walls cycle through the provided DISTINCT textures
    with per-wall crop offsets so repeats stay decorrelated."""
    walls = []
    half_u = radius * np.tan(np.pi / n_walls) * 1.02  # tiny overlap, no gaps
    for i in range(n_walls):
        phi = 2 * np.pi * i / n_walls
        outward = np.array([np.sin(phi), 0.0, np.cos(phi)])
        origin = radius * outward
        ax_u = np.array([np.cos(phi), 0.0, -np.sin(phi)])
        ax_v = np.array([0.0, 1.0, 0.0])
        tex = textures[i % len(textures)]
        th, tw = tex.shape
        # vary the crop per wall so texture repeats differ
        rng = np.random.default_rng(i)
        ch, cw = int(th * 0.75), int(tw * 0.75)
        oy = rng.integers(0, th - ch + 1)
        ox = rng.integers(0, tw - cw + 1)
        walls.append(
            OrientedPlane(
                origin=origin, ax_u=ax_u, ax_v=ax_v,
                half_u=float(half_u), half_v=half_height,
                tex=np.ascontiguousarray(tex[oy : oy + ch, ox : ox + cw]),
            )
        )
    return walls


def circle_trajectory(
    n_frames: int,
    radius: float = 4.0,
    closed: bool = True,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Camera circling at `radius`, looking radially outward — every view
    is fresh until the circuit closes, so drift accumulates monotonically
    and only a loop closure can correct it. Returns (rvec, tvec) pairs.
    With closed=True the final frame re-reaches the start viewpoint."""
    poses = []
    denom = n_frames if closed else n_frames - 1
    for i in range(n_frames):
        theta = 2 * np.pi * i / denom
        rvec = np.array([0.0, theta, 0.0], np.float32)
        R = np.array(
            [
                [np.cos(theta), 0, np.sin(theta)],
                [0, 1, 0],
                [-np.sin(theta), 0, np.cos(theta)],
            ]
        )
        # camera +z (view dir) of R = roty(theta) is (-sin, 0, cos) in
        # world (third row of R); the center sits on the same ray so the
        # camera always looks radially outward
        c = radius * np.array([-np.sin(theta), 0.0, np.cos(theta)])
        poses.append((rvec, (-R @ c).astype(np.float32)))
    return poses
