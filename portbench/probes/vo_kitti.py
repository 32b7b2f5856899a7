"""A probe of traffic that is not a cell yet: the monocular VO engine at
KITTI 00's camera, to see how far the card paces it.

    python3 -m portbench.probes.vo_kitti --seed <n> [--frames 160] [--traced 16] [--out FILE]

The seeded splat renderer of chip_smoke.py (points on a relief surface,
the camera sliding right with slight forward motion and yaw), copied here
at KITTI's 1241 x 376 grey frames and its sequence-00 P0 intrinsics
(fx = fy = 718.856, cx = 607.1928, cy = 185.2157), with ORB-SLAM2's
KITTI00-02.yaml extractor settings (2000 features, scale 1.2, 8 levels,
FAST 20). Prints one JSON line: set-up seconds (imports, kernel build,
rendering, a cold run), frames/s of one `process_sequence` over the clip
on a fresh engine, and, from `torch.profiler` over a fresh engine's first
`--traced` frames, the device's idle share and kernels a frame.
Nothing here is judged against a reference: it reports, for the choice
of a later cell.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import trace  # noqa: E402

W, H = 1241, 376
K = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]], np.float32)


def _rodrigues_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def render(n_frames: int, seed: int, device) -> np.ndarray:
    """[F, H, W] float32 frames: 20 000 splatted points of a seeded relief
    surface wide enough for KITTI's field of view, blurred on the card."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    n_pts = 20000
    wx = rng.uniform(-9.0, 12.0 + 0.12 * n_frames, n_pts)
    wy = rng.uniform(-4.5, 4.5, n_pts)
    wz = 7.0 + 2.8 * np.sin(0.85 * wx) * np.cos(0.7 * wy) + 1.5 * np.cos(1.3 * wx + 0.9 * wy) + 0.1 * wx
    world = np.stack([wx, wy, wz], 1).astype(np.float32)
    inten = rng.uniform(60, 255, n_pts).astype(np.float32)
    f, cx, cy = K[0, 0], K[0, 2], K[1, 2]
    raw = np.zeros((n_frames, H, W), np.float32)
    for i in range(n_frames):
        c = np.array([0.12 * i, 0.0, 0.03 * i], np.float32)
        pc = (world - c) @ _rodrigues_y(np.deg2rad(0.15 * i)).T
        z = pc[:, 2]
        vis = z > 0.5
        u = f * pc[:, 0] / np.where(vis, z, 1.0) + cx
        v = f * pc[:, 1] / np.where(vis, z, 1.0) + cy
        vis &= (u >= 2) & (u < W - 2) & (v >= 2) & (v < H - 2)
        uf, vf, ii = u[vis], v[vis], inten[vis]
        u0, v0 = np.floor(uf).astype(int), np.floor(vf).astype(int)
        au, av = uf - u0, vf - v0
        for du, dv, wgt in ((0, 0, (1 - au) * (1 - av)), (1, 0, au * (1 - av)), (0, 1, (1 - au) * av),
                            (1, 1, au * av)):
            np.add.at(raw[i], (v0 + dv, u0 + du), ii * wgt)
    x = torch.from_numpy(raw).to(device)[:, None]
    g = torch.exp(-torch.arange(-2, 3, dtype=torch.float32, device=device) ** 2 / (2 * 1.1 ** 2))
    g = g / g.sum()
    x = F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"), g.view(1, 1, 1, 5))
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"), g.view(1, 1, 5, 1))
    return (x[:, 0] * 4.0).clamp(0, 255).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--traced", type=int, default=16)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vo_kitti: no CUDA device", file=sys.stderr)
        return 2
    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.ops.cuda import _build
    from opencv_tpu_torch.slam.vo import VisualOdometry, VOConfig

    _build.build()
    cfg = VOConfig(orb=ORBConfig(n_features=2000, scale_factor=1.2, n_levels=8, fast_threshold=20.0))
    frames = render(args.frames, args.seed, "cuda")
    VisualOdometry(K, cfg, seed=0).process_sequence(frames[:16], chunk=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    vo = VisualOdometry(K, cfg, seed=0)
    t0 = time.perf_counter()
    vo.process_sequence(frames, chunk=8)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    t = trace.profile(lambda: VisualOdometry(K, cfg, seed=0).process_sequence(frames[:args.traced], chunk=8),
                      Path(__file__).resolve().parents[2] / "build" / "portbench" / "vo_trace.json")
    line = {"seed": args.seed, "frames": args.frames, "setup_s": setup_s, "seconds": elapsed,
            "frames_per_s": args.frames / elapsed, "keyframes": len(vo.keyframes), "state": vo.state,
            "traced_frames": args.traced, "device_idle_pct": 100.0 * (1.0 - t["busy_s"] / t["window_s"]),
            "kernels_per_frame": t["kernels"] / args.traced, "window_s": t["window_s"],
            "device_ops": t["device_ops"][:5], "idle_gaps": t["idle_gaps"][:5],
            "kind": torch.cuda.get_device_name(0)}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
