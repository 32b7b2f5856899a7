"""DetectionBasedTracker of the PyTorch port (tbd/detection_based.py)
against the JAX package on the CPU, on the first 5 frames of
tests/test_detection_based.py's scene: a textured square moves; the
detector fires every 4th frame, LK flow of GFTT corners carries the box
in between.

Tolerance: the same detector calls and track IDs, boxes within 0.05 px
(the LK rule: the port's LK agrees with JAX's at 0.05 px on tracked
points, tests/test_torch_lk.py).
"""

import numpy as np

from opencv_tpu.tbd.detection_based import DetectionBasedTracker as JDBT
from opencv_tpu_torch.tbd.detection_based import DetectionBasedTracker as TDBT

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_detection_based import _frame


def _bright_box_detector(calls):
    def detector(img):
        calls.append(1)
        ys, xs = np.where(np.asarray(img) > 90)
        if len(xs) == 0:
            return np.zeros((0, 4), np.float32)
        return np.array([[xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()]],
                        np.float32)
    return detector


def test_detection_based_tracker_equals_jax():
    rng = np.random.default_rng(1234)
    size = 28
    tex = rng.uniform(100, 255, (size, size)).astype(np.float32)
    # 5 of the scene's 10 frames: eager JAX compiles LK's step loops anew
    # for each call (several seconds each)
    true_pos = [(10 + 3 * t, 20 + 2 * t) for t in range(5)]
    frames = [_frame(tex, p) for p in true_pos]
    jcalls, tcalls = [], []
    jd = JDBT(_bright_box_detector(jcalls), detect_interval=4)
    td = TDBT(_bright_box_detector(tcalls), detect_interval=4, device="cpu")
    for k, f in enumerate(frames):
        want, got = jd.process_frame(f), td.process_frame(f)
        assert [t.track_id for t in got] == [t.track_id for t in want], k
        assert [t.track_id for t in td.tracker.tracks] == [t.track_id for t in jd.tracker.tracks]
        for a, b in zip(jd.tracker.tracks, td.tracker.tracks):
            assert (a.age, a.total_visible) == (b.age, b.total_visible)
            np.testing.assert_allclose(b.bbox, a.bbox, atol=0.05, err_msg=str(k))
        if k >= 3:
            cx = got[0].bbox[0] + got[0].bbox[2] / 2
            cy = got[0].bbox[1] + got[0].bbox[3] / 2
            assert abs(cx - (true_pos[k][0] + size / 2)) < 6
            assert abs(cy - (true_pos[k][1] + size / 2)) < 6
    assert len(tcalls) == len(jcalls) == 2  # frames 0 and 4
