"""The VO engine of the PyTorch port against the JAX engine on the CPU.

Engine randomness differs between the packages (jax.random keys against a
torch.Generator), so whole runs are judged as tests/test_vo.py judges the
JAX engine: Sim(3)-aligned ATE under 5 % of the path, and the keyframe
counts of the two engines side by side. Deterministic stages (keyframe
triangulation, map matching) are fed the same inputs in both packages and
compared directly; the map reaches both through `convert.load_map`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from opencv_tpu.core.config import ORBConfig as JORBConfig
from opencv_tpu.slam import vo as jvo
from opencv_tpu_torch import convert
from opencv_tpu_torch.slam import vo as tvo
from opencv_tpu_torch.utils.evaluate import ate_rmse

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_vo import K, synthetic_sequence  # noqa: F401  (module fixture)

ENGINE_KW = dict(n_hypotheses=512, keyframe_min_inliers=80, window_size=5, ba_iters=8)


def _jax_cfg():
    return jvo.VOConfig(orb=JORBConfig(n_features=600, n_levels=3, fast_threshold=12.0),
                        **ENGINE_KW)


def _port_cfg():
    return convert.vo_config_from_dict(dataclasses.asdict(_jax_cfg()))


def _path(centers):
    return float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())


def test_configs_carry_across():
    from opencv_tpu.core import config as jconfig
    from opencv_tpu_torch.core import config as tconfig

    for name in ("FASTConfig", "ORBConfig", "LKConfig", "RansacConfig", "MatchConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())
    assert dataclasses.asdict(tvo.VOConfig()) == dataclasses.asdict(jvo.VOConfig())
    jcfg = _jax_cfg()
    assert dataclasses.asdict(_port_cfg()) == dataclasses.asdict(jcfg)
    with pytest.raises(KeyError):
        convert.vo_config_from_dict({"no_such_field": 1})


def test_load_map_keeps_descriptor_bits(rng):
    desc = rng.integers(0, 2 ** 32, size=(50, 8), dtype=np.uint64).astype(np.uint32)
    pos, d, v = convert.load_map(rng.normal(size=(50, 3)), desc, np.ones(50, bool), device="cpu")
    assert pos.dtype == torch.float32 and d.dtype == torch.int32 and v.dtype == torch.bool
    np.testing.assert_array_equal(d.numpy().view(np.uint32), desc)


def test_engine_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvo.VisualOdometry(K, _port_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_map(np.zeros((1, 3)), np.zeros((1, 8), np.uint32), np.ones(1, bool))
    assert tvo.VisualOdometry(K, _port_cfg(), device="cpu").device.type == "cpu"


def test_stages_equal_jax_on_the_same_map(synthetic_sequence):  # noqa: F811
    """Keyframe triangulation between frames 0 and 4 at the true relative
    pose, then map tracking of frame 8 against the map it built, in both
    packages from the same detections."""
    frames, _, poses = synthetic_sequence
    jcfg, tcfg = _jax_cfg(), _port_cfg()
    ks = jvo._compiled_kernels(jcfg, (float(K[0, 0]), float(K[1, 1]),
                                      float(K[0, 2]), float(K[1, 2])))
    st = tvo._Stages(tcfg, K, torch.device("cpu"))
    det = [tvo._fetch(st.detect(torch.from_numpy(frames[i].astype(np.float32))))
           for i in (0, 4, 8)]

    def rot(rv):
        return tvo._np_rodrigues(rv)

    R_rel = rot(poses[4][0]) @ rot(poses[0][0]).T
    t_rel = (poses[4][1] - R_rel @ poses[0][1]).astype(np.float32)
    none = np.zeros(det[0]["kvalid"].shape, bool)
    args = (det[0]["desc"], det[0]["kvalid"], det[0]["xy"], none,
            det[1]["desc"], det[1]["kvalid"], det[1]["xy"], none, R_rel, t_rel)
    tj = jax.device_get(ks["tri"](*args))
    tt = tvo._fetch(st.tri(*[
        tvo._to_dev_desc(a, "cpu") if a.dtype == np.uint32 else torch.from_numpy(np.asarray(a))
        for a in args]))
    for k in ("qi", "ti", "n_fresh"):
        np.testing.assert_array_equal(tt[k], tj[k])
    good = tj["good"]
    assert good.sum() > 100
    assert (tt["good"] == good).mean() >= 0.995  # depth/reprojection gates in f32
    # 3x3 normal equations in f32: measured <= 5e-4 absolute, on far points
    np.testing.assert_allclose(tt["X0"][good], tj["X0"][good], rtol=1e-4, atol=1e-4)

    # the map built above (world = camera 0), fed to both through load_map
    lm_pos = tj["X0"][good]
    lm_desc = det[1]["desc"][tj["ti"][good]]
    lm_valid = np.ones(good.sum(), bool)
    jp = jax.device_get(ks["pnp_map"](det[2]["xy"], det[2]["desc"], det[2]["kvalid"],
                                      lm_pos, lm_desc, lm_valid, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    tp = tvo._fetch(st.pnp_map(torch.from_numpy(det[2]["xy"]), tvo._to_dev_desc(det[2]["desc"], "cpu"),
                               torch.from_numpy(det[2]["kvalid"]),
                               *convert.load_map(lm_pos, lm_desc, lm_valid, device="cpu"), gen))
    np.testing.assert_array_equal(tp["ti"], jp["ti"])
    np.testing.assert_array_equal(tp["mv"], jp["mv"])
    assert bool(tp["ok"]) and bool(jp["ok"]) and int(tp["n_inl"]) > 100
    # different RANSAC draws, the same Gauss-Newton optimum: measured
    # <= 5.7e-7 apart over three seeds
    for k in ("rvec", "tvec"):
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5)
    np.testing.assert_allclose(tp["rvec"], poses[8][0], atol=3e-3)
    np.testing.assert_allclose(tp["tvec"], poses[8][1], atol=3e-2)


@pytest.mark.parametrize("mode", ["process", "process_sequence"])
def test_port_engine_tracks_synthetic_sequence(synthetic_sequence, mode):  # noqa: F811
    frames, centers, _ = synthetic_sequence
    vo = tvo.VisualOdometry(K, _port_cfg(), seed=0, device="cpu")
    if mode == "process":
        for f in frames:
            vo.process(f)
        traj = vo.trajectory()
    else:
        traj = vo.process_sequence(np.asarray(frames), chunk=8)
    assert vo.state == "tracking"
    assert len(vo.keyframes) >= 2
    assert traj.shape == (len(frames), 3) and np.isfinite(traj).all()
    assert ate_rmse(traj, centers, with_scale=True) < 0.05 * _path(centers)


@pytest.mark.slow
def test_both_engines_on_synthetic_sequence(synthetic_sequence):  # noqa: F811
    frames, centers, _ = synthetic_sequence
    bound = 0.05 * _path(centers)
    jv = jvo.VisualOdometry(K, _jax_cfg(), seed=0)
    tv = tvo.VisualOdometry(K, _port_cfg(), seed=0, device="cpu")
    for f in frames:
        jv.process(f)
        tv.process(f)
    assert jv.state == tv.state == "tracking"
    ate_j = ate_rmse(jv.trajectory(), centers, with_scale=True)
    ate_t = ate_rmse(tv.trajectory(), centers, with_scale=True)
    assert ate_j < bound and ate_t < bound, (ate_j, ate_t, bound)
    # keyframe decisions hang on RANSAC draws near the inlier gates
    assert abs(len(jv.keyframes) - len(tv.keyframes)) <= 2, (len(jv.keyframes), len(tv.keyframes))


def _klt_cfgs():
    jcfg = dataclasses.replace(_jax_cfg(), tracker="klt")
    return jcfg, convert.vo_config_from_dict(dataclasses.asdict(jcfg))


def test_unknown_tracker_raises():
    with pytest.raises(ValueError, match="unknown tracker"):
        tvo.VisualOdometry(K, dataclasses.replace(_port_cfg(), tracker="sift"), device="cpu")


def test_port_klt_engine_tracks_synthetic_sequence(synthetic_sequence):  # noqa: F811
    """tracker="klt": LK carries the pose between keyframes; the JAX engine
    tracked 14 of these 20 frames by LK at 0.43 % of the path."""
    frames, centers, _ = synthetic_sequence
    vo = tvo.VisualOdometry(K, _klt_cfgs()[1], seed=0, device="cpu")
    traj = vo.process_sequence(np.asarray(frames))
    assert vo.state == "tracking"
    assert vo.lk_tracked >= 1
    assert traj.shape == (len(frames), 3) and np.isfinite(traj).all()
    assert ate_rmse(traj, centers, with_scale=True) < 0.05 * _path(centers)


@pytest.mark.slow
def test_both_klt_engines_on_synthetic_sequence(synthetic_sequence):  # noqa: F811
    frames, centers, _ = synthetic_sequence
    bound = 0.05 * _path(centers)
    jcfg, tcfg = _klt_cfgs()
    jv = jvo.VisualOdometry(K, jcfg, seed=0)
    tv = tvo.VisualOdometry(K, tcfg, seed=0, device="cpu")
    for f in frames:
        jv.process(f)
        tv.process(f)
    assert jv.state == tv.state == "tracking"
    assert tv.lk_tracked >= 1
    ate_j = ate_rmse(jv.trajectory(), centers, with_scale=True)
    ate_t = ate_rmse(tv.trajectory(), centers, with_scale=True)
    assert ate_j < bound and ate_t < bound, (ate_j, ate_t, bound)
    assert abs(len(jv.keyframes) - len(tv.keyframes)) <= 2, (len(jv.keyframes), len(tv.keyframes))
