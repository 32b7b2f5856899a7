"""utils/ of the PyTorch port and the three `core/types.py` helpers
against the JAX package on the CPU.

Tolerance: none. Persistence writes the same .npz/.json pair, so a state
saved by either package loads in the other with equal arrays and
scalars; the renderer (`synth.render_sequence`, `splat_frame`) and the
drawings of `viz` are host numpy around the port's rodrigues and
Gaussian blur, and equal JAX's bit for bit; `camera_matrix`,
`take_keypoints` and `pad_to` equal JAX's. The guard and profiler tests
hold the behaviour of tests/test_guard.py and tests/test_utils.py.
"""

import dataclasses
import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core import types as JTy
from opencv_tpu.utils import persistence as JP
from opencv_tpu.utils import synth as JS
from opencv_tpu.utils import viz as JV
from opencv_tpu_torch.core import types as TTy
from opencv_tpu_torch.utils import guard, logger, persistence, profiler, synth, viz

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


@dataclasses.dataclass
class _Cfg:
    n: int = 3
    name: str = "orb"


def _state(rng):
    return {
        "poses": rng.normal(size=(5, 6)).astype(np.float32),
        "landmarks": {"pos": rng.normal(size=(100, 3)).astype(np.float32),
                      "valid": rng.random(100) > 0.5},
        "frames": 42, "name": "kitti00", "scales": [1.0, 1.2, 1.44],
        "pair": (np.arange(3, dtype=np.int32), 7), "none_field": None, "config": _Cfg(),
    }


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persistence_crosses_between_packages(tmp_path, rng, writer):
    state = _state(rng)
    path = str(tmp_path / "ckpt")
    (persistence if writer == "port" else JP).save_state(path, state)
    a, b = persistence.load_state(path), JP.load_state(path)
    _same(a, b)
    np.testing.assert_array_equal(a["poses"], state["poses"])
    assert a["config"] == {"n": 3, "name": "orb"}


def test_persistence_saves_tensors_as_jax_saves_arrays(tmp_path, rng):
    state = _state(rng)
    as_tensors = dict(state, poses=torch.from_numpy(state["poses"]),
                      landmarks={k: torch.from_numpy(v) for k, v in state["landmarks"].items()})
    persistence.save_state(str(tmp_path / "t"), as_tensors)
    JP.save_state(str(tmp_path / "j"), state)
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f) == json.load(g)
    _same(JP.load_state(str(tmp_path / "t")), JP.load_state(str(tmp_path / "j")))


def test_persistence_refuses_unknown_objects(tmp_path):
    with pytest.raises(TypeError):
        persistence.save_state(str(tmp_path / "x"), {"f": object()})


def test_profiler_regions():
    profiler.reset()
    profiler.enable(True)
    try:
        with profiler.profile_region("outer"):
            with profiler.profile_region("inner"):
                sum(range(1000))
        rep = profiler.report()
        assert "outer" in rep and "inner" in rep
        assert rep["outer"][1] == 1 and rep["outer"][0] >= rep["inner"][0]
    finally:
        profiler.enable(False)
        profiler.reset()
    with profiler.profile_region("off"):
        pass
    assert profiler.report() == {}


def test_profiler_regions_reach_the_device_trace(tmp_path):
    profiler.start_device_trace(str(tmp_path))
    with profiler.profile_region("port.region"):
        torch.ones(8).sum()
    path = profiler.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port.region" for e in events)


def test_logger_levels(capsys):
    log = logger.get_logger("opencv_tpu_torch.test")
    log.warning("a warning")
    assert "a warning" in capsys.readouterr().err


class _Out(NamedTuple):
    a: torch.Tensor
    b: int


def test_checked_raises_on_a_non_finite_output():
    g = guard.checked(torch.log)
    assert torch.isfinite(g(torch.tensor(2.0)))
    with pytest.raises(ValueError, match="non-finite"):
        g(torch.tensor(-1.0))
    h = guard.checked(lambda x: {"ok": x, "out": _Out(torch.log(x), 3)})
    with pytest.raises(ValueError, match=r"\['out'\]\.a"):
        h(torch.tensor([1.0, -1.0]))
    # integer outputs and a NaN that never reaches an output pass
    assert guard.checked(lambda x: (x > 0, torch.nan_to_num(torch.log(x))))(torch.tensor(-1.0))


def test_assert_finite_walks_nested_structures():
    guard.assert_finite({"a": torch.ones(3), "b": [np.ones(2), (torch.zeros(1),)]})
    with pytest.raises(FloatingPointError, match=r"state\['a'\]\[1\]"):
        guard.assert_finite({"a": [torch.ones(1), torch.tensor([1.0, float("inf")])]}, "state")
    with pytest.raises(FloatingPointError, match=r"\.a"):
        guard.assert_finite(_Out(torch.tensor([float("nan")]), 0))


def test_determinism_check(rng):
    from opencv_tpu_torch.core.config import ORBConfig
    from opencv_tpu_torch.ops import orb

    img = torch.from_numpy(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    assert guard.determinism_check(lambda a: orb.detect_and_compute(
        a, ORBConfig(n_features=256, n_levels=3)), img)
    calls = iter(range(10))
    assert not guard.determinism_check(lambda: torch.tensor([float(next(calls))]))
    assert not guard.determinism_check(lambda: torch.zeros(int(next(calls)) + 1))


def _texture(rng, h=64, w=96):
    yy, xx = np.mgrid[0:h, 0:w]
    return (128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
            + rng.normal(0, 20, (h, w))).astype(np.float32)


def test_render_sequence_equals_jax(rng):
    tex = _texture(rng)
    K = np.array([[80.0, 0, 40], [0, 80.0, 30], [0, 0, 1]], np.float32)
    fa, ca = synth.render_sequence(tex, K, 60, 80, n_frames=4)
    fb, cb = JS.render_sequence(tex, K, 60, 80, n_frames=4)
    assert fa.dtype == fb.dtype and ca.dtype == cb.dtype
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ca, cb)
    walls = synth.prism_scene([tex, tex[::-1]], n_walls=6)
    traj = synth.circle_trajectory(3)
    fa, ca = synth.render_sequence(tex, K, 40, 56, n_frames=3, planes=walls, trajectory=traj)
    fb, cb = JS.render_sequence(tex, K, 40, 56, n_frames=3, planes=JS.prism_scene(
        [tex, tex[::-1]], n_walls=6), trajectory=JS.circle_trajectory(3))
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ca, cb)


def test_splat_frame_equals_jax(rng):
    pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400),
                    rng.uniform(4, 9, 400)], 1).astype(np.float32)
    inten = rng.uniform(60, 255, 400).astype(np.float32)
    K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1]], np.float32)
    rvec = np.array([0.01, -0.05, 0.02], np.float32)
    tvec = np.array([0.1, 0.0, 0.2], np.float32)
    np.testing.assert_array_equal(synth.splat_frame(pts, inten, rvec, tvec, K, 60, 80),
                                  JS.splat_frame(pts, inten, rvec, tvec, K, 60, 80))


def test_viz_drawings_equal_jax(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    field = rng.normal(0, 2, (16, 20, 2)).astype(np.float32)
    outs = []
    for mod in (viz, JV):
        rgb = mod.to_rgb(img)
        mod.draw_rect(rgb, (10, 10, 20, 15), thickness=2)
        mod.put_text(rgb, "FPS: 12.5", (2, 40))
        kp = mod.draw_keypoints(img, [[5, 5], [60, 40], [30, 20]], valid=[True, False, True],
                                color=(255, 0, 0))
        m = mod.draw_matches(img, [[5, 5], [9, 30]], img, [[6, 6], [40, 12]], [[0, 0], [1, 1]])
        outs.append((rgb, kp, m, mod.flow_to_color(field)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_imshow_and_plots_write_files(tmp_path, rng):
    viz.imshow(str(tmp_path / "a.png"), rng.uniform(0, 255, (20, 30)))
    JV.imshow(str(tmp_path / "b.png"), rng.uniform(0, 255, (20, 30)))
    assert open(tmp_path / "a.png", "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"
    t = np.linspace(0, 4 * np.pi, 60)
    poses = np.stack([np.cos(t), 0.1 * t, np.sin(t)], 1)
    viz.plot_trajectory(str(tmp_path / "traj.png"), poses, gt_poses=poses + 0.05,
                        landmarks=rng.normal(0, 1, (100, 3)))
    viz.plot_birdseye(str(tmp_path / "bird.png"), poses)
    assert os.path.getsize(tmp_path / "traj.png") > 5000
    assert os.path.getsize(tmp_path / "bird.png") > 5000


def test_camera_matrix_equals_jax():
    got = TTy.camera_matrix(525.0, 520.5, 319.5, 239.5, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(JTy.camera_matrix(525.0, 520.5, 319.5, 239.5)))


def test_take_keypoints_equals_jax(rng):
    n = 12
    fields = dict(xy=rng.normal(size=(n, 2)).astype(np.float32),
                  response=rng.normal(size=n).astype(np.float32),
                  angle=rng.normal(size=n).astype(np.float32),
                  level=rng.integers(0, 4, n).astype(np.int32),
                  size=rng.uniform(1, 9, n).astype(np.float32), valid=rng.random(n) > 0.3)
    jk = JTy.KeyPoints(**{k: jnp.asarray(v) for k, v in fields.items()})
    tk = TTy.KeyPoints(**{k: torch.from_numpy(v) for k, v in fields.items()})
    idx = np.array([3, 0, 0, 11, 5])
    sel = np.array([True, True, False, True, True])
    for valid in (None, sel):
        a = TTy.take_keypoints(tk, torch.from_numpy(idx), None if valid is None else torch.from_numpy(valid))
        b = JTy.take_keypoints(jk, jnp.asarray(idx), None if valid is None else jnp.asarray(valid))
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))


@pytest.mark.parametrize("n,axis,fill", [(7, 0, 0), (2, 0, 0), (5, 1, -1.5), (3, 1, 9)])
def test_pad_to_equals_jax(rng, n, axis, fill):
    x = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(TTy.pad_to(torch.from_numpy(x), n, axis, fill).numpy(),
                                  np.asarray(JTy.pad_to(jnp.asarray(x), n, axis, fill)))


def test_camera_matrix_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTy.camera_matrix(1.0, 1.0, 0.0, 0.0)
