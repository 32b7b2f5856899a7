"""Tracking-by-detection of the PyTorch port (ops/kalman.py, tbd/assignment.py,
tbd/tracker.py) against the JAX package on the CPU.

Tolerances:
- Kalman predict/correct: 1e-5 relative (the einsums contract in another
  order than XLA's; both are f32);
- assignments: equal (the same native solver, and scipy's optimum cost);
- iou_matrix: bit-equal (the same f32 operations);
- trackers: the same confirmed track IDs every frame, boxes within 1e-3
  px, equal MOT counters. The port corrects all assigned tracks in one
  batched call where JAX loops over them; the filters are independent.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from opencv_tpu.ops import kalman as jkalman
from opencv_tpu.tbd import MotMetrics as JMot, TbdConfig as JCfg, Tracker as JTracker
from opencv_tpu.tbd import assignment as jassign
from opencv_tpu.tbd.tracker import iou_matrix as j_iou
from opencv_tpu_torch import convert
from opencv_tpu_torch.ops import kalman as tkalman
from opencv_tpu_torch.ops.cuda import _build
from opencv_tpu_torch.tbd import MotMetrics as TMot, TbdConfig as TCfg, Tracker as TTracker
from opencv_tpu_torch.tbd import assignment as tassign
from opencv_tpu_torch.tbd.tracker import iou_matrix as t_iou

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


# ---------- kalman ----------

def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("batch", [(), (5,), (3, 4)])
def test_kalman_predict_correct_equal_jax(batch):
    rng = np.random.default_rng(len(batch))
    jm = jkalman.constant_velocity_model(4, process_noise=0.03, measurement_noise=0.2)
    tm = tkalman.constant_velocity_model(4, process_noise=0.03, measurement_noise=0.2, device="cpu")
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    F, H, Q, R, _ = (m.numpy() for m in tm)
    x = rng.normal(0, 50, batch + (8,)).astype(np.float32)
    A = rng.normal(0, 1, batch + (8, 8)).astype(np.float32)
    P = (A @ np.swapaxes(A, -1, -2) + np.eye(8, dtype=np.float32)).astype(np.float32)
    z = rng.normal(0, 50, batch + (4,)).astype(np.float32)
    js = jkalman.predict(jkalman.KalmanState(jnp.asarray(x), jnp.asarray(P)), jnp.asarray(F), jnp.asarray(Q))
    ts = tkalman.predict(tkalman.KalmanState(torch.from_numpy(x), torch.from_numpy(P)),
                         torch.from_numpy(F), torch.from_numpy(Q))
    _close(ts.x, js.x)
    _close(ts.P, js.P)
    js = jkalman.correct(js, jnp.asarray(H), jnp.asarray(R), jnp.asarray(z))
    ts = tkalman.correct(ts, torch.from_numpy(H), torch.from_numpy(R), torch.from_numpy(z))
    _close(ts.x, js.x)
    _close(ts.P, js.P)


def test_batched_correct_equals_one_track_at_a_time():
    """The tracker's one batched correct == JAX's per-track loop."""
    rng = np.random.default_rng(2)
    boxes = rng.uniform(0, 200, (6, 4)).astype(np.float32)
    batched, looped = TTracker(device="cpu"), TTracker(device="cpu")
    for t in (batched, looped):
        t._add_track(boxes, np.zeros(6, np.int64), np.ones(6))
        t._predict()
    z = boxes + rng.normal(0, 2, boxes.shape).astype(np.float32)
    sel = np.array([0, 2, 3, 5])
    batched._correct(sel, z[sel])
    for i in sel:
        looped._correct(int(i), z[i])
    np.testing.assert_allclose(batched._kf.x.numpy(), looped._kf.x.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(batched._kf.P.numpy(), looped._kf.P.numpy(), rtol=1e-6, atol=1e-6)


# ---------- assignment ----------

def _total(cost, assign):
    return sum(cost[r, c] for r, c in enumerate(assign) if c >= 0)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 8), (7, 12), (25, 25), (12, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_solver_equals_jax_scipy_and_numpy(shape):
    """(12, 7) is the transposed case (N > M)."""
    cost = np.random.default_rng(sum(shape)).uniform(0, 10, shape)
    got = tassign.linear_assignment(cost)
    np.testing.assert_array_equal(got, jassign.linear_assignment(cost))
    ri, ci = linear_sum_assignment(cost)
    assert abs(_total(cost, got) - cost[ri, ci].sum()) < 1e-9
    if shape[0] <= shape[1]:
        np.testing.assert_array_equal(tassign._solve_native(cost), tassign._solve_numpy(cost))
        np.testing.assert_array_equal(tassign._solve_numpy(cost), jassign._solve_numpy(cost))


@pytest.mark.parametrize("cost_unassigned", [0.3, 0.45, 0.6])
def test_assign_with_unassigned_cost_equals_jax(cost_unassigned):
    rng = np.random.default_rng(7)
    for n, m in [(0, 3), (3, 0), (2, 3), (6, 4), (9, 9)]:
        cost = 1.0 - rng.uniform(0, 1, (n, m)) ** 3
        got = tassign.assign_with_unassigned_cost(cost, cost_unassigned)
        want = jassign.assign_with_unassigned_cost(cost, cost_unassigned)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_failed_build_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A source that does not compile raises; the NumPy solver is not used."""
    (tmp_path / "munkres.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tassign, "_solve_numpy", lambda cost: pytest.fail("fell back"))
    with pytest.raises(RuntimeError, match="build failed"):
        tassign.linear_assignment(np.ones((2, 2)))


def test_solver_error_raises_instead_of_falling_back():
    """JAX drops to NumPy when the native solver returns an error; the port raises."""
    with pytest.raises(RuntimeError, match="returned 2"):
        tassign.linear_assignment(np.full((2, 3), np.inf))


# ---------- iou ----------

def test_iou_matrix_bit_equal():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0, 100, (9, 2)), rng.uniform(1, 40, (9, 2))], 1).astype(np.float32)
    b = np.concatenate([rng.uniform(0, 100, (7, 2)), rng.uniform(1, 40, (7, 2))], 1).astype(np.float32)
    b[0] = a[0]
    b[1] = [500, 500, 3, 3]
    np.testing.assert_array_equal(t_iou(a, b, device="cpu").numpy(), j_iou(a, b))
    assert t_iou(a[:0], b, device="cpu").shape == (0, 7)


def test_mot_metrics_equal_jax():
    rng = np.random.default_rng(5)
    jm, tm = JMot(), TMot(device="cpu")
    for _ in range(10):
        gt = rng.uniform(0, 200, (6, 4)).astype(np.float32)
        tr = gt[rng.random(6) > 0.2] + rng.normal(0, 3, (1, 4)).astype(np.float32)
        for m in (jm, tm):
            m.update(tr, gt)
            m.update(tr[:0], gt[:2])
    assert (tm.tp, tm.fp, tm.fn, tm.gt) == (jm.tp, jm.fp, jm.fn, jm.gt)
    assert tm.overlap_sum == pytest.approx(jm.overlap_sum, rel=1e-6)


# ---------- trackers ----------

def _same_tracks(jt, tt, tol=1e-3):
    assert [t.track_id for t in tt.tracks] == [t.track_id for t in jt.tracks]
    for a, b in zip(jt.tracks, tt.tracks):
        assert (a.class_id, a.age, a.total_visible, a.consecutive_invisible) == (
            b.class_id, b.age, b.total_visible, b.consecutive_invisible)
        assert a.confidence == pytest.approx(b.confidence)
        np.testing.assert_allclose(b.bbox, a.bbox, atol=tol)
    assert tt.next_id == jt.next_id


def test_trackers_agree_through_crossing():
    """tests/test_tbd.py's crossing scene."""
    jt, tt = JTracker(JCfg()), TTracker(TCfg(), device="cpu")
    for frame in range(30):
        boxes = np.array([[10 + 4 * frame, 20, 12, 24], [150 - 4 * frame, 22, 12, 24]], np.float32)
        det = boxes + np.random.default_rng(frame).normal(0, 0.3, boxes.shape)
        got, want = tt.step(det), jt.step(det)
        assert [t.track_id for t in got] == [t.track_id for t in want]
        _same_tracks(jt, tt)
    assert len([t for t in tt.tracks if t.confirmed]) == 2


def _app_gt(t):
    """examples/tbd_app.py's scene: three pedestrians and two vehicles."""
    peds = np.array([[20 + 3.0 * t, 40 + 0.5 * t, 14, 30], [300 - 2.5 * t, 60, 14, 30],
                     [40 + 2.0 * t, 120, 14, 30]], np.float32)
    vehicles = np.array([[10 + 6.0 * t, 200, 40, 24], [500 - 5.0 * t, 230, 44, 26]], np.float32)
    return peds, vehicles


@pytest.mark.parametrize("carry", ["own_snapshots", "jax_snapshots"])
def test_trackers_agree_on_tbd_app_history_7_3(carry):
    """examples/tbd_app.py with --history_distribution 7,3: each frame the
    trackers restore the snapshot of one or two frames back. The port
    restores its own snapshots, or the JAX tracker's carried across by
    convert.tracker_snapshot."""
    rng = np.random.default_rng(0)
    hist = np.array([0.7, 0.3])
    jts = [JTracker(JCfg()), JTracker(JCfg())]
    tts = [TTracker(TCfg(), device="cpu"), TTracker(TCfg(), device="cpu")]
    jms = [JMot(), JMot()]
    tms = [TMot(device="cpu"), TMot(device="cpu")]
    jbuf, tbuf = [[None] * 2, [None] * 2], [[None] * 2, [None] * 2]
    for t in range(40):
        gts = _app_gt(t)
        dets = []
        for g in gts:
            keep = rng.random(len(g)) > 0.15
            dets.append(g[keep] + rng.normal(0, 0.8, (keep.sum(), 4)).astype(np.float32))
        age = int(rng.choice(2, p=hist)) + 1
        for c in range(2):
            if t >= age:
                jts[c].set_tracks(jbuf[c][(t - age) % 2])
                snap = (tbuf[c][(t - age) % 2] if carry == "own_snapshots"
                        else convert.tracker_snapshot(jbuf[c][(t - age) % 2], device="cpu"))
                tts[c].set_tracks(snap)
            else:
                jts[c].reset()
                tts[c].reset()
            want, got = jts[c].step(dets[c]), tts[c].step(dets[c])
            assert [x.track_id for x in got] == [x.track_id for x in want], (t, c)
            _same_tracks(jts[c], tts[c])
            jbuf[c][t % 2], tbuf[c][t % 2] = jts[c].get_tracks(), tts[c].get_tracks()
            if t >= 5 and want:
                jms[c].update(np.stack([x.bbox for x in want]), gts[c])
                tms[c].update(np.stack([x.bbox for x in got]), gts[c])
    for jm, tm in zip(jms, tms):
        assert (tm.tp, tm.fp, tm.fn, tm.gt) == (jm.tp, jm.fp, jm.fn, jm.gt)
        assert tm.mota > 0.8


def test_snapshots_are_deep_copies():
    tt = TTracker(device="cpu")
    for t in range(4):
        tt.step(np.array([[10.0 + 3 * t, 20.0, 12, 20]], np.float32))
    snap = tt.get_tracks()
    box = snap[0][0].bbox.copy()
    x = snap[2][0].clone()
    tt.step(np.array([[30.0, 20.0, 12, 20]], np.float32))
    np.testing.assert_array_equal(snap[0][0].bbox, box)
    assert torch.equal(snap[2][0], x)
    tt.set_tracks(snap)
    assert tt.tracks[0] is not snap[0][0]
    tt.reset()
    assert tt.tracks == [] and tt.step(np.zeros((0, 4), np.float32)) == []


def test_convert_tracker_snapshot_fields():
    jt = JTracker(JCfg())
    for t in range(4):
        jt.step(np.array([[10.0 + 3 * t, 20.0, 12, 20], [80, 40, 10, 10]], np.float32))
    tracks, next_id, kf = convert.tracker_snapshot(jt.get_tracks(), device="cpu")
    assert next_id == jt.next_id
    for a, b in zip(jt.tracks, tracks):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        assert b.bbox.dtype == np.float32 and b.track_id == a.track_id
    np.testing.assert_array_equal(kf[0].numpy(), np.asarray(jt._kf.x))
    np.testing.assert_array_equal(kf[1].numpy(), np.asarray(jt._kf.P))
