"""Ported functions that no other port test names, held against the JAX
package on the CPU on seeded inputs.

- ONNX operators through both packages' importers (`_run_onnx` of
  tests/test_torch_dnn.py: rtol/atol 1e-5): the unary ops, three-input
  Min, Sigmoid, Relu, Dropout, Identity, InstanceNormalization,
  BatchNormalization, ReduceMean and ReduceMin, nearest and linear
  Upsample, and Conv with dilation 2, two groups, asymmetric pads and
  stride (1, 2).
- Geometry and image functions: equal to JAX within 1e-6 (absolute, on
  values of order one; most are bit-equal): `calibration.distort`,
  `epipolar.enforce_essential`, `enforce_rank2`, `sampson_error` (1e-5
  relative), `homography.dlt_homography` (1e-4 relative: H is the null
  vector of a noisy 12-point system, solved in another library) and
  `homography_transfer_error` (1e-5 relative),
  `pnp.project_points`, `rotation.quat_to_matrix` and `solve3`,
  `superres.btv_regularizer_grad`, `sgbm.aggregate` (integer-valued
  costs: exact), `evaluate.umeyama_alignment` and
  `global_stitch.focals_from_homography` (host f64: 1e-9 relative).
- `decompose_essential` on one E only: for a batch, JAX's `u[:, 2]`
  takes row 2 of every U where the port takes each E's own third column;
  on one E the two agree (within 1e-5: the top-2 Jacobi triplets' last
  bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.geometry import calibration as j_cal
from opencv_tpu.geometry import epipolar as j_epi
from opencv_tpu.geometry import homography as j_hom
from opencv_tpu.geometry import pnp as j_pnp
from opencv_tpu.geometry import rotation as j_rot
from opencv_tpu.ops import sgbm as j_sgbm
from opencv_tpu.ops import superres as j_sr
from opencv_tpu.stitching import global_stitch as j_gs
from opencv_tpu.utils import evaluate as j_ev
from opencv_tpu_torch.geometry import calibration as t_cal
from opencv_tpu_torch.geometry import epipolar as t_epi
from opencv_tpu_torch.geometry import homography as t_hom
from opencv_tpu_torch.geometry import pnp as t_pnp
from opencv_tpu_torch.geometry import rotation as t_rot
from opencv_tpu_torch.ops import sgbm as t_sgbm
from opencv_tpu_torch.ops import superres as t_sr
from opencv_tpu_torch.stitching import global_stitch as t_gs
from opencv_tpu_torch.utils import evaluate as t_ev

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from test_dnn_importers import _attr_float, _attr_int, _attr_ints, _node, _onnx_tensor
from test_torch_dnn import _attr_str, _run_onnx

f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ ONNX


def _onnx_cases(rng):
    def r(*s, scale=1.0):
        return rng.normal(0, scale, s).astype(f32)

    pos = np.abs(r(2, 3, 4, 5)) + 0.1
    c = 3
    unary = [_node(op, ["input" if i == 0 else f"u{i - 1}"], [f"u{i}"])
             for i, op in enumerate(["Exp", "Log", "Cos", "Sin", "Neg", "Ceil", "Floor", "Reciprocal"])]
    return {
        "unary_chain": (unary + [_node("Identity", ["u7"], ["out"])], [], pos),
        "min_of_three": ([_node("Sigmoid", ["input"], ["s"]), _node("Relu", ["input"], ["rl"]),
                          _node("Min", ["input", "s", "rl"], ["m"]),
                          _node("Dropout", ["m"], ["out"])], [], r(2, 3, 4, 5)),
        "instance_and_batch_norm": (
            [_node("InstanceNormalization", ["input", "sc", "bi"], ["in"], [_attr_float("epsilon", 1e-4)]),
             _node("BatchNormalization", ["in", "g", "b", "mu", "va"], ["out"])],
            [_onnx_tensor("sc", r(c)), _onnx_tensor("bi", r(c)), _onnx_tensor("g", r(c)),
             _onnx_tensor("b", r(c)), _onnx_tensor("mu", r(c, scale=0.1)),
             _onnx_tensor("va", np.abs(r(c)) + 0.5)], r(2, c, 5, 6)),
        "reduce_mean_min": (
            [_node("ReduceMean", ["input"], ["rm"], [_attr_ints("axes", [2, 3]), _attr_int("keepdims", 1)]),
             _node("ReduceMin", ["input"], ["rn"], [_attr_ints("axes", [1]), _attr_int("keepdims", 1)]),
             _node("Add", ["rm", "rn"], ["out"])], [], r(2, 3, 4, 5)),
        "upsample_nearest": ([_node("Upsample", ["input", "sc"], ["out"], [_attr_str("mode", "nearest")])],
                             [_onnx_tensor("sc", np.array([1, 1, 2, 3], f32))], r(1, 2, 3, 4)),
        "upsample_linear": ([_node("Upsample", ["input", "sc"], ["out"], [_attr_str("mode", "linear")])],
                            [_onnx_tensor("sc", np.array([1, 1, 2, 2], f32))], r(1, 2, 3, 4)),
        "conv_dilated_grouped_asymmetric": (
            [_node("Conv", ["input", "w", "b"], ["out"],
                   [_attr_ints("dilations", [2, 2]), _attr_int("group", 2),
                    _attr_ints("pads", [1, 0, 2, 1]), _attr_ints("strides", [1, 2])])],
            [_onnx_tensor("w", r(4, 2, 3, 3, scale=0.3)), _onnx_tensor("b", r(4, scale=0.1))],
            r(2, 4, 9, 11)),
    }


@pytest.mark.parametrize("case", ["unary_chain", "min_of_three", "instance_and_batch_norm",
                                  "reduce_mean_min", "upsample_nearest", "upsample_linear",
                                  "conv_dilated_grouped_asymmetric"])
def test_onnx_ops_equal_jax(rng, case):
    nodes, inits, x = _onnx_cases(rng)[case]
    _run_onnx(nodes, inits, x)


# ------------------------------------------------------- geometry and co.


def _rand_rot(rng, n=None):
    v = rng.normal(0, 0.4, (3,) if n is None else (n, 3)).astype(f32)
    return v


def _essential(rng):
    R = np.asarray(j_rot.rodrigues(jnp.asarray(_rand_rot(rng))))
    t = rng.normal(size=3).astype(f32)
    t /= np.linalg.norm(t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], f32)
    return (tx @ R).astype(f32) + rng.normal(0, 0.01, (3, 3)).astype(f32)


def test_distort_equals_jax(rng):
    xy = rng.uniform(-0.6, 0.6, (50, 2)).astype(f32)
    dist = np.array([-0.2, 0.05, 0.001, -0.001, 0.01], f32)
    _close(t_cal.distort(_t(xy), _t(dist)), j_cal.distort(jnp.asarray(xy), jnp.asarray(dist)))


def test_enforce_essential_rank2_and_sampson_equal_jax(rng):
    E = np.stack([_essential(rng) for _ in range(4)])
    _close(t_epi.enforce_essential(_t(E)), j_epi.enforce_essential(jnp.asarray(E)))
    _close(t_epi.enforce_rank2(_t(E)), j_epi.enforce_rank2(jnp.asarray(E)))
    x1 = rng.uniform(-0.5, 0.5, (30, 2)).astype(f32)
    x2 = rng.uniform(-0.5, 0.5, (30, 2)).astype(f32)
    want = np.stack([j_epi.sampson_error(jnp.asarray(e), jnp.asarray(x1), jnp.asarray(x2)) for e in E])
    _close(t_epi.sampson_error(_t(E), _t(x1), _t(x2)), want, rtol=1e-5)


def test_decompose_essential_on_one_e(rng):
    E = _essential(rng)
    for got, want in zip(t_epi.decompose_essential(_t(E)), j_epi.decompose_essential(jnp.asarray(E))):
        _close(got, want, atol=1e-5)


def test_dlt_homography_and_transfer_error_equal_jax(rng):
    H = np.array([[1.1, 0.05, 3.0], [-0.02, 0.95, -2.0], [1e-4, -2e-4, 1.0]], f32)
    x1 = rng.uniform(0, 100, (3, 12, 2)).astype(f32)
    h = np.concatenate([x1, np.ones((3, 12, 1), f32)], -1) @ H.T
    x2 = (h[..., :2] / h[..., 2:]).astype(f32) + rng.normal(0, 0.1, (3, 12, 2)).astype(f32)
    Ht, okt = t_hom.dlt_homography(_t(x1), _t(x2))  # batched in the port
    for b in range(3):
        Hj, okj = j_hom.dlt_homography(jnp.asarray(x1[b]), jnp.asarray(x2[b]))
        _close(Ht[b], Hj, atol=1e-7, rtol=1e-4)
        assert bool(okt[b]) == bool(okj)
    _close(t_hom.homography_transfer_error(_t(H), _t(x1[0]), _t(x2[0])),
           j_hom.homography_transfer_error(jnp.asarray(H), jnp.asarray(x1[0]), jnp.asarray(x2[0])),
           atol=1e-4, rtol=1e-5)


def test_project_points_quat_and_solve3_equal_jax(rng):
    rv, tv = _rand_rot(rng, 4), rng.normal(0, 0.3, (4, 3)).astype(f32)
    obj = np.concatenate([rng.uniform(-1, 1, (20, 2)), rng.uniform(3, 6, (20, 1))], 1).astype(f32)
    want = np.stack([j_pnp.project_points(jnp.asarray(r), jnp.asarray(t), jnp.asarray(obj))
                     for r, t in zip(rv, tv)])
    _close(t_pnp.project_points(_t(rv), _t(tv), _t(obj)), want)
    q = rng.normal(size=(6, 4)).astype(f32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(t_rot.quat_to_matrix(_t(q)), j_rot.quat_to_matrix(jnp.asarray(q)))
    M = (rng.normal(size=(5, 3, 3)) + 3 * np.eye(3)).astype(f32)
    b = rng.normal(size=(5, 3)).astype(f32)
    _close(t_rot.solve3(_t(M), _t(b)), j_rot.solve3(jnp.asarray(M), jnp.asarray(b)))


def test_btv_regularizer_grad_equals_jax(rng):
    x = rng.uniform(0, 255, (24, 30)).astype(f32)
    for btv_range, alpha in ((2, 0.7), (1, 0.5)):
        _close(t_sr.btv_regularizer_grad(_t(x), btv_range, alpha),
               j_sr.btv_regularizer_grad(jnp.asarray(x), btv_range, alpha), atol=1e-5)


def test_sgbm_aggregate_equals_jax(rng):
    cvol = rng.integers(0, 60, (16, 20, 24)).astype(f32)
    cfg_t, cfg_j = t_sgbm.SGBMConfig(num_disparities=16), j_sgbm.SGBMConfig(num_disparities=16)
    np.testing.assert_array_equal(t_sgbm.aggregate(_t(cvol), cfg_t).numpy(),
                                  np.asarray(j_sgbm.aggregate(jnp.asarray(cvol), cfg_j)))


def test_umeyama_and_focals_equal_jax(rng):
    src = rng.normal(size=(40, 3))
    R = np.asarray(j_rot.rodrigues(jnp.asarray(_rand_rot(rng))), np.float64)
    dst = 1.7 * src @ R.T + np.array([0.3, -1.0, 2.0]) + rng.normal(0, 0.01, (40, 3))
    for scale in (True, False):
        for got, want in zip(t_ev.umeyama_alignment(src, dst, scale), j_ev.umeyama_alignment(src, dst, scale)):
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    f = 420.0
    K = np.array([[f, 0, 160], [0, f, 120], [0, 0, 1]])
    Rz = np.asarray(j_rot.rodrigues(jnp.asarray(np.array([0.02, 0.3, 0.01], f32))), np.float64)
    H = K @ Rz @ np.linalg.inv(K)
    got, want = t_gs.focals_from_homography(H), j_gs.focals_from_homography(H)
    assert (got[0] is None) == (want[0] is None) and (got[1] is None) == (want[1] is None)
    np.testing.assert_allclose([v for v in got if v is not None], [v for v in want if v is not None],
                               rtol=1e-9)
