"""Monocular visual odometry on a synthetic 3D scene, end to end (port of
examples/vo_synthetic.py).

    python -m opencv_tpu_torch.examples.vo_synthetic [--cpu] [--frames N]

1600 textured points on a relief surface, splatted and blurred into
240x320 frames as the camera slides right and forward with a slight
yaw; `VisualOdometry` (ORB with 600 features at 3 levels: FAST kernel K1
on every frame, the streaming 2-NN kernel K3 at keyframe retrieval)
tracks them. Prints each frame's state and the Sim(3)-aligned ATE-RMSE;
exits 0 when the ATE is below 5 % of the path. The engine's RANSAC draws
from the port's own generator, not from JAX's PRNG.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.config import ORBConfig
from opencv_tpu_torch.device import resolve_device, synchronize
from opencv_tpu_torch.geometry.rotation import rodrigues
from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig
from opencv_tpu_torch.utils.evaluate import ate_rmse

H, W, F = 240, 320, 260.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
VO_CONFIG = VOConfig(orb=ORBConfig(n_features=600, n_levels=3, fast_threshold=12.0),
                     n_hypotheses=512, keyframe_min_inliers=80, window_size=5, ba_iters=8)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.vo_synthetic",
                                 description="Monocular VO on a synthetic scene.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--frames", type=int, default=20)
    return ap


def scene() -> tuple[np.ndarray, np.ndarray]:
    """The seeded world: (points f32 [1600, 3], intensities f32 [1600])."""
    rng = np.random.default_rng(7)
    n = 1600
    wx = rng.uniform(-6, 8, n)
    wy = rng.uniform(-4, 4, n)
    wz = (7.0 + 2.8 * np.sin(0.85 * wx) * np.cos(0.7 * wy)
          + 1.5 * np.cos(1.3 * wx + 0.9 * wy) + 0.35 * wx)
    world = np.stack([wx, wy, wz], 1).astype(np.float32)
    return world, rng.uniform(60, 255, n).astype(np.float32)


def rotation(rvec: np.ndarray) -> np.ndarray:
    """The port's f32 Rodrigues of `rvec`, as a numpy f32 [3, 3]."""
    return rodrigues(torch.as_tensor(rvec, dtype=torch.float32)).numpy()


def pose(i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame i's (camera centre, rvec, tvec): the camera slides right and
    forward and yaws 0.3 deg a frame."""
    c = np.array([0.12 * i, 0.0, 0.05 * i], np.float32)
    rvec = np.array([0.0, np.deg2rad(0.3 * i), 0.0], np.float32)
    return c, rvec, (-rotation(rvec) @ c).astype(np.float32)


def render(world: np.ndarray, inten: np.ndarray, rvec: np.ndarray, tvec: np.ndarray,
           dev) -> np.ndarray:
    """Bilinear splats of the visible points, blurred (5, 1.1) on `dev`,
    x4 and clipped to [0, 255]: f32 [H, W] on the host."""
    pc = world @ rotation(rvec).T + tvec
    z = pc[:, 2]
    vis = z > 0.5
    u = F * pc[:, 0] / z + W / 2
    v = F * pc[:, 1] / z + H / 2
    vis &= (u >= 2) & (u < W - 2) & (v >= 2) & (v < H - 2)
    img = np.zeros((H, W), np.float32)
    uf, vf = u[vis], v[vis]
    u0, v0 = np.floor(uf).astype(int), np.floor(vf).astype(int)
    au, av = uf - u0, vf - v0
    ii = inten[vis]
    np.add.at(img, (v0, u0), ii * (1 - au) * (1 - av))
    np.add.at(img, (v0, u0 + 1), ii * au * (1 - av))
    np.add.at(img, (v0 + 1, u0), ii * (1 - au) * av)
    np.add.at(img, (v0 + 1, u0 + 1), ii * au * av)
    img = imgproc.gaussian_blur(torch.from_numpy(img).to(dev), 5, 1.1).cpu().numpy()
    return np.clip(img * 4.0, 0, 255)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    world, inten = scene()
    vo = VisualOdometry(K, VO_CONFIG, device=dev)
    centers, frames = [], []
    for i in range(args.frames):
        c, rvec, tvec = pose(i)
        img = render(world, inten, rvec, tvec, dev)
        synchronize(dev)
        t0 = time.perf_counter()
        vo.process(img)
        synchronize(dev)
        secs = time.perf_counter() - t0
        centers.append(c)
        frames.append(dict(state=vo.state, keyframes=len(vo.keyframes),
                           landmarks=int(vo.lm_valid.sum()), secs=secs))
        print(f"frame {i:3d}  state={vo.state:13s} keyframes={len(vo.keyframes):2d} "
              f"landmarks={frames[-1]['landmarks']:4d}  ({secs:.2f}s)")
    centers = np.asarray(centers)
    path = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
    err = ate_rmse(vo.trajectory(), centers)
    print(f"\npath length {path:.3f}  ATE-RMSE (Sim3-aligned) {err:.4f} "
          f"({100 * err / path:.2f}% of path)")
    return dict(frames=frames, path=path, ate=err, ate_share=err / path,
                state=vo.state, keyframes=len(vo.keyframes), ok=bool(err < 0.05 * path))


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
