"""Multi-object tracking-by-detection, the fork's own module (port of
opencv_tpu/tbd/tracker.py).

Behaviour of modules/trackingbydetection:
- Detection / Track records with class ids and confidence (tbd.hpp:77-121);
- constant-velocity prediction (predictNewLocationsOfTracks, tbd.cpp:288);
- cost = 1 - IoU between predicted track boxes and detections
  (tbd.cpp:345-348);
- optimal assignment with a cost of non-assignment (Munkres, here the
  host solver of tbd/assignment.py);
- track lifecycle: create on an unassigned detection, age and visibility
  bookkeeping, delete stale tracks (Tracker::performTrackingStep,
  tbd.cpp:210);
- MOT counters TP/FN/FP/GT/overlap (tbd.hpp:146-151) -> MOTA/MOTP.

The batched Kalman state of all tracks stays on the tracker's device. A
step predicts every track in one call, computes the IoU cost there and
moves only the cost matrix to the host for Munkres; it corrects every
assigned track in one batched call (the filters are independent, so this
equals the JAX code's per-track loop) and reads the boxes back once.
Track records and their boxes are host numpy, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import kalman
from opencv_tpu_torch.tbd.assignment import assign_with_unassigned_cost


@dataclasses.dataclass(frozen=True)
class TbdConfig:
    """Analog of TbdArgs (tbd.hpp:25-41)."""

    cost_of_non_assignment: float = 0.6  # in 1-IoU units
    invisible_threshold: int = 5  # consecutive misses before deletion
    min_age_threshold: int = 3  # age before a track counts as confirmed
    min_visibility_ratio: float = 0.5
    process_noise: float = 1e-2
    measurement_noise: float = 1e-1


@dataclasses.dataclass
class Track:
    """Analog of tbd::Track (tbd.hpp:96-121)."""

    track_id: int
    class_id: int
    bbox: np.ndarray  # [4] (x, y, w, h) current corrected box
    age: int = 1
    total_visible: int = 1
    consecutive_invisible: int = 0
    confidence: float = 1.0

    @property
    def confirmed(self) -> bool:
        return self.age >= 3 and self.total_visible / self.age >= 0.5


def iou_matrix(boxes_a, boxes_b, device=None) -> torch.Tensor:
    """Pairwise IoU of (x, y, w, h) boxes: f32 [Na, Nb]. Tensors stay on
    their device; numpy inputs go to the card unless `device="cpu"`."""
    if not isinstance(boxes_a, torch.Tensor):
        device = resolve_device(device)
    else:
        device = boxes_a.device
    a = torch.as_tensor(boxes_a, dtype=torch.float32, device=device).reshape(-1, 4)[:, None, :]
    b = torch.as_tensor(boxes_b, dtype=torch.float32, device=device).reshape(-1, 4)[None, :, :]
    if a.shape[0] == 0 or b.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=device)
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2])
    y2 = torch.minimum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union.clamp(min=1e-9)


class MotMetrics:
    """Per-frame MOT counters (tbd.hpp:146-151) and derived MOTA/MOTP.
    The IoU runs on `device` (the card unless `device="cpu"`)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.tp = 0
        self.fp = 0
        self.fn = 0
        self.gt = 0
        self.overlap_sum = 0.0

    def update(self, track_boxes, gt_boxes, iou_thresh=0.5):
        iou = iou_matrix(track_boxes, gt_boxes, self.device).cpu().numpy()
        n_tracks, n_gt = iou.shape
        self.gt += n_gt
        if iou.size == 0:
            self.fp += n_tracks
            self.fn += n_gt
            return
        row_to_col, _, un_cols = assign_with_unassigned_cost(1.0 - iou, 1.0 - iou_thresh)
        matched = row_to_col >= 0
        self.tp += int(matched.sum())
        self.fp += int((~matched).sum())
        self.fn += len(un_cols)
        self.overlap_sum += float(iou[np.flatnonzero(matched), row_to_col[matched]].sum())

    @property
    def mota(self) -> float:
        return 1.0 - (self.fn + self.fp) / max(self.gt, 1)

    @property
    def motp(self) -> float:
        return self.overlap_sum / max(self.tp, 1)


class Tracker:
    """Analog of tbd::Tracker (tbd.hpp:139, tbd.cpp:210). Runs on the card
    unless `device="cpu"`."""

    def __init__(self, config: TbdConfig = TbdConfig(), device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.tracks: list[Track] = []
        self.next_id = 0
        self._F, self._H, self._Q, self._R, self._P0 = kalman.constant_velocity_model(
            4, process_noise=config.process_noise,
            measurement_noise=config.measurement_noise, device=self.device)
        self._kf: kalman.KalmanState | None = None  # batched over tracks

    # ---- internals ----

    def _predict(self) -> torch.Tensor:
        """Advance all track filters one step; returns the predicted boxes
        [T, 4] on the device."""
        if not self.tracks:
            return torch.zeros((0, 4), dtype=torch.float32, device=self.device)
        self._kf = kalman.predict(self._kf, self._F, self._Q)
        return self._kf.x[:, :4]

    def _correct(self, idx, boxes):
        """Measurement update of the tracks `idx` (an index or a sequence)
        with boxes [len(idx), 4] (or one box [4]), in one batched call."""
        sel = torch.as_tensor(np.atleast_1d(np.asarray(idx, np.int64)), device=self.device)
        z = torch.as_tensor(np.asarray(boxes, np.float32), device=self.device).reshape(-1, 4)
        st = kalman.correct(kalman.KalmanState(self._kf.x[sel], self._kf.P[sel]),
                            self._H, self._R, z)
        x, P = self._kf.x.clone(), self._kf.P.clone()
        x[sel], P[sel] = st.x, st.P
        self._kf = kalman.KalmanState(x, P)

    def _add_track(self, boxes, class_ids, confidences):
        """New tracks for boxes [K, 4] with K class ids and confidences;
        the filters are appended in one call."""
        boxes = np.asarray(boxes, np.float32)
        for b, cid, conf in zip(boxes, class_ids, confidences):
            self.tracks.append(Track(self.next_id, int(cid), b.copy(), confidence=float(conf)))
            self.next_id += 1
        z = torch.as_tensor(boxes, device=self.device)
        x0 = torch.cat([z, torch.zeros_like(z)], dim=1)
        P0 = self._P0.expand(len(boxes), -1, -1)
        if self._kf is None:
            self._kf = kalman.KalmanState(x0, P0.clone())
        else:
            self._kf = kalman.KalmanState(torch.cat([self._kf.x, x0]),
                                          torch.cat([self._kf.P, P0]))

    def _delete(self, keep_mask: np.ndarray):
        self.tracks = [t for t, k in zip(self.tracks, keep_mask) if k]
        if not self.tracks:
            self._kf = None
        elif not keep_mask.all():
            sel = torch.as_tensor(np.flatnonzero(keep_mask), device=self.device)
            self._kf = kalman.KalmanState(self._kf.x[sel], self._kf.P[sel])

    # ---- public API ----

    def get_tracks(self):
        """Snapshot of the full track state (the reference app's getTracks,
        samples/gpu/tbd.cpp:704, used by the --history_distribution
        stale-state experiments): (tracks, next_id, (x, P) or None). Deep
        copy: stepping the live tracker never changes a stored snapshot.
        The filter state stays on the device."""
        kf = None if self._kf is None else (self._kf.x.clone(), self._kf.P.clone())
        return copy.deepcopy(self.tracks), self.next_id, kf

    def set_tracks(self, snapshot):
        """Restore a get_tracks() snapshot (the reference's setTracks,
        samples/gpu/tbd.cpp:685): the next step() runs against these
        possibly stale tracks instead of the tracker's own latest."""
        tracks, next_id, kf = snapshot
        self.tracks = copy.deepcopy(tracks)
        self.next_id = next_id
        self._kf = None if kf is None else kalman.KalmanState(
            torch.as_tensor(kf[0], device=self.device).clone(),
            torch.as_tensor(kf[1], device=self.device).clone())

    def reset(self):
        """Drop all tracks (the reference's Tracker::reset)."""
        self.tracks = []
        self.next_id = 0
        self._kf = None

    def step(self, det_boxes, det_classes=None, det_confidences=None) -> list[Track]:
        """One tracking step (performTrackingStep, tbd.cpp:210).
        det_boxes: [D, 4] (x, y, w, h). Returns the live confirmed tracks."""
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        d = det_boxes.shape[0]
        det_classes = np.zeros(d, np.int64) if det_classes is None else np.asarray(det_classes)
        det_confidences = (np.ones(d, np.float32) if det_confidences is None
                           else np.asarray(det_confidences))

        predicted = self._predict()
        if self.tracks and d:
            # the one transfer before the assignment: the cost matrix
            cost = (1.0 - iou_matrix(predicted, det_boxes, self.device)).cpu().numpy()
        else:
            cost = np.zeros((len(self.tracks), d), np.float32)
        row_to_col, _, un_dets = assign_with_unassigned_cost(cost, self.cfg.cost_of_non_assignment)

        assigned = np.flatnonzero(row_to_col >= 0)
        if assigned.size:
            self._correct(assigned, det_boxes[row_to_col[assigned]])
        if self.tracks:
            # corrected boxes of the assigned tracks, predicted ones of the
            # rest: one read for all
            boxes = self._kf.x[:, :4].cpu().numpy()
        for ti, (tr, di) in enumerate(zip(self.tracks, row_to_col)):
            tr.bbox = boxes[ti].copy()
            tr.age += 1
            if di >= 0:
                tr.total_visible += 1
                tr.consecutive_invisible = 0
                tr.confidence = float(det_confidences[di])
            else:
                tr.consecutive_invisible += 1

        keep = np.array([
            t.consecutive_invisible <= self.cfg.invisible_threshold
            and (t.age < self.cfg.min_age_threshold
                 or t.total_visible / t.age >= self.cfg.min_visibility_ratio)
            for t in self.tracks
        ], bool)
        self._delete(keep)

        if len(un_dets):
            self._add_track(det_boxes[un_dets], det_classes[un_dets], det_confidences[un_dets])
        return [t for t in self.tracks if t.confirmed]
