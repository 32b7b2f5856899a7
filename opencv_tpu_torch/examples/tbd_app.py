"""Tracking-by-detection application (port of examples/tbd_app.py, the
analog of samples/gpu/tbd.cpp, the fork's flagship sample).

    python -m opencv_tpu_torch.examples.tbd_app [--cpu] [--frames N]
        [--drop_rate P] [--history_distribution 7,3] [--num_tracking_iters N]

Frame loop: ground-truth boxes jittered by 0.8 px with `--drop_rate` of
them dropped (the reference's `--use_gt` mode) -> a tbd Tracker step per
class -> MOT metrics from frame 5 and the frame rates (the reference's
hogWorkFps and frame FPS overlays, tbd.cpp:1123-1151). The scene:
pedestrians (class 0) and vehicles (class 1) at constant velocity. Under
a history distribution such as "7,3" each step restores the track state
of 1 or 2 frames back (the ISORC'20 stale-state experiment,
tbd.cpp:173,645-704). Exits 0 when both classes' MOTA exceed 0.8.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from opencv_tpu_torch.device import resolve_device, synchronize
from opencv_tpu_torch.tbd import MotMetrics, TbdConfig, Tracker

METRICS_FROM = 5  # MotMetrics from this frame on


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.tbd_app",
                                 description="Tracking-by-detection on a synthetic scene.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--drop_rate", type=float, default=0.15)
    ap.add_argument(
        "--history_distribution", default="1",
        help="comma-separated distribution over the AGE of the track state fed to each "
        "tracking step (e.g. '7,3' = 0.7 chance of the prior frame's tracks, 0.3 of two "
        "frames back): the ISORC'20 stale-state experiment (tbd.cpp:173,645-704)")
    ap.add_argument("--num_tracking_iters", type=int, default=1,
                    help="repeat the whole tracking experiment N times (tbd.cpp:179)")
    return ap


def history_distribution(text: str) -> np.ndarray:
    """'7,3' -> [0.7, 0.3]: the normalised distribution over ages 1, 2, ..."""
    dist = np.array([float(v) for v in text.split(",")], np.float64)
    return dist / dist.sum()


def gt_boxes(t: int) -> tuple[np.ndarray, np.ndarray]:
    """Frame t's (x, y, w, h) boxes: three pedestrians, two vehicles."""
    peds = np.array([[20 + 3.0 * t, 40 + 0.5 * t, 14, 30],
                     [300 - 2.5 * t, 60, 14, 30],
                     [40 + 2.0 * t, 120, 14, 30]], np.float32)
    vehicles = np.array([[10 + 6.0 * t, 200, 40, 24],
                         [500 - 5.0 * t, 230, 44, 26]], np.float32)
    return peds, vehicles


def run_experiment(rng: np.random.Generator, frames: int, drop_rate: float,
                   history_dist: np.ndarray, dev) -> tuple[MotMetrics, MotMetrics, float, list[int]]:
    """One full tracking pass (tbd.cpp:498): per frame, jittered detections
    with dropouts, an age drawn from the history distribution, the track
    state stored that many frames back restored from a ring buffer, a step
    of each class's tracker, the result stored (tbd.cpp:629-706). Returns
    (pedestrian metrics, vehicle metrics, tracking-only seconds, ages)."""
    trackers = [Tracker(TbdConfig(), device=dev), Tracker(TbdConfig(), device=dev)]
    metrics = [MotMetrics(device=dev), MotMetrics(device=dev)]
    hlen = len(history_dist)
    bufs = [[None] * hlen, [None] * hlen]  # ring buffers of track snapshots
    ages, t_track = [], 0.0
    for t in range(frames):
        gts = gt_boxes(t)
        dets = []
        for gt in gts:
            keep = rng.random(len(gt)) > drop_rate
            dets.append(gt[keep] + rng.normal(0, 0.8, (keep.sum(), 4)).astype(np.float32))
        age = int(rng.choice(hlen, p=history_dist)) + 1  # age 1 = the previous frame
        ages.append(age)
        synchronize(dev)
        t0 = time.perf_counter()
        confirmed = []
        for c, trk in enumerate(trackers):
            if hlen > 1:
                snap = bufs[c][(t - age) % hlen] if t >= age else None
                if snap is not None:
                    trk.set_tracks(snap)
                else:
                    trk.reset()
            confirmed.append(trk.step(dets[c]))
            if hlen > 1:
                bufs[c][t % hlen] = trk.get_tracks()
        synchronize(dev)
        t_track += time.perf_counter() - t0
        if t >= METRICS_FROM:
            for c, conf in enumerate(confirmed):
                if conf:
                    metrics[c].update(np.stack([tr.bbox for tr in conf]), gts[c])
    return metrics[0], metrics[1], t_track, ages


def _figures(m: MotMetrics) -> dict:
    return dict(mota=float(m.mota), motp=float(m.motp), tp=int(m.tp), fp=int(m.fp), fn=int(m.fn))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    history = history_distribution(args.history_distribution)
    rng = np.random.default_rng(0)
    synchronize(dev)
    t0_all = time.perf_counter()
    iter_fps = []
    for it in range(args.num_tracking_iters):
        ped, veh, t_track, ages = run_experiment(rng, args.frames, args.drop_rate, history, dev)
        iter_fps.append(args.frames / max(t_track, 1e-9))
        if args.num_tracking_iters > 1:
            print(f"iter {it}: tracking-only {iter_fps[-1]:.1f} FPS")
    synchronize(dev)
    wall = time.perf_counter() - t0_all
    out = dict(frames=args.frames, wall_s=wall, fps=args.frames / wall, tracking_fps=iter_fps[-1],
               iter_tracking_fps=iter_fps, pedestrians=_figures(ped), vehicles=_figures(veh))
    if len(history) > 1:
        counts = np.bincount(ages, minlength=len(history) + 1)
        out["history_ages"] = {a: int(c) for a, c in enumerate(counts) if a >= 1}
        print("history ages used:", out["history_ages"])
    print(f"frames: {args.frames}  total {wall:.2f}s "
          f"({args.frames / wall:.1f} FPS, tracking-only {out['tracking_fps']:.1f} FPS)")
    for label, m in (("pedestrians:", ped), ("vehicles:   ", veh)):
        print(f"{label} MOTA={m.mota:.3f} MOTP={m.motp:.3f} TP={m.tp} FP={m.fp} FN={m.fn}")
    out["ok"] = bool(ped.mota > 0.8 and veh.mota > 0.8)
    print("OK" if out["ok"] else "DEGRADED")
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
