"""DetectionBasedTracker: heavy detection at intervals, cheap optical-flow
box tracking in between (port of opencv_tpu/tbd/detection_based.py).

Reference: objdetect/src/detection_based_tracker.cpp, where a background
thread runs the cascade detector every few frames while the main loop
keeps rectangles alive with a light tracker. As in the JAX package both
cadences run synchronously: the detector every `detect_interval` frames,
and every frame pyramidal LK (ops/lk.py) of GFTT corners found inside
each live box, the median corner displacement moving the box, which then
corrects the box's Kalman filter. Track lifecycle is the TBD tracker's.

The JAX code builds both LK pyramids anew for every box; they are the
same for every box, so the port builds them once per frame pair and
calls the pyramid-reuse LK per box (the same arithmetic). At 480x640 the
level-0 LK sites go through kernel K4 (ops/cuda/lk_sample.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from opencv_tpu_torch.core.config import LKConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import gftt, lk
from opencv_tpu_torch.tbd.tracker import TbdConfig, Tracker


class DetectionBasedTracker:
    """detector(img np [H, W] f32) -> boxes np [D, 4] (x, y, w, h). GFTT,
    LK and the tracker run on the card unless `device="cpu"`."""

    def __init__(
        self,
        detector: Callable[[np.ndarray], np.ndarray],
        detect_interval: int = 4,
        max_track_points: int = 32,
        config: TbdConfig | None = None,
        device=None,
    ):
        self.detector = detector
        self.detect_interval = detect_interval
        self.max_track_points = max_track_points
        self.device = resolve_device(device)
        self.tracker = Tracker(config or TbdConfig(), self.device)
        self._frame_idx = 0
        self._prev: torch.Tensor | None = None

    def _flow_boxes(self, prev: torch.Tensor, cur: torch.Tensor, boxes: np.ndarray) -> np.ndarray:
        """Shift each box by the median LK displacement of the GFTT corners
        found inside it."""
        if len(boxes) == 0:
            return boxes
        cfg = LKConfig()
        pyr_prev = lk.build_flow_pyramid(prev, cfg, self.device)
        pyr_cur = lk.build_flow_pyramid(cur, cfg, self.device)
        h, w = prev.shape
        out = boxes.copy()
        for i, (x, y, bw, bh) in enumerate(boxes):
            x0, y0 = int(max(x, 0)), int(max(y, 0))
            x1, y1 = int(min(x + bw, w)), int(min(y + bh, h))
            if x1 - x0 < 8 or y1 - y0 < 8:
                continue
            kp = gftt.good_features_to_track(prev[y0:y1, x0:x1], self.max_track_points,
                                             device=self.device)
            # float64, as the JAX code's f32 corners plus an int list
            pts = kp.xy.cpu().numpy() + [x0, y0]
            valid = kp.valid.cpu().numpy()
            if valid.sum() < 3:
                continue
            new_pts, status, _ = lk.calc_optical_flow_pyr_lk_pyr(
                pyr_prev, pyr_cur, torch.as_tensor(pts, dtype=torch.float32, device=self.device),
                kp.valid, cfg)
            ok = status.cpu().numpy() & valid
            if ok.sum() < 3:
                continue
            d = np.median(new_pts.cpu().numpy()[ok] - pts[ok], axis=0)
            out[i, 0] += d[0]
            out[i, 1] += d[1]
        return out

    def process_frame(self, img):
        """Advance one frame; returns the live confirmed tracks."""
        img = np.asarray(img, np.float32)
        cur = torch.as_tensor(img, device=self.device)
        run_detector = self._frame_idx % self.detect_interval == 0

        if self._prev is not None and self.tracker.tracks:
            # the cheap pass of every frame: the flow-moved boxes are each
            # track's Kalman measurement, all corrected in one call
            boxes = np.stack([t.bbox for t in self.tracker.tracks])
            moved = self._flow_boxes(self._prev, cur, boxes).astype(np.float32)
            self.tracker._correct(np.arange(len(moved)), moved)
            for t, b in zip(self.tracker.tracks, moved):
                t.bbox = b

        if run_detector:
            det = np.asarray(self.detector(img), np.float32).reshape(-1, 4)
            tracks = self.tracker.step(det)
        else:
            # flow-tracked frames count as visible frames for the lifecycle
            # (the reference's tracked rectangles keep their tracks alive
            # between detector runs)
            for t in self.tracker.tracks:
                t.age += 1
                t.total_visible += 1
            tracks = [t for t in self.tracker.tracks if t.confirmed]

        self._prev = cur
        self._frame_idx += 1
        return tracks
