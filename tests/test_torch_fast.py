"""FAST kernels K1/K2 of the PyTorch port: plain versions against the JAX
XLA path and the interpret-mode Pallas kernels, exact; the multi-level
entry `fast_corners_levels` (one launch per pyramid on the card) against
the one-level plain version and the XLA path; ORB's one call of it per
image. The CUDA kernels are held against these plain versions on a card
in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opencv_tpu.ops import fast as jfast
from opencv_tpu.ops.pallas import fast_kernel as jpallas
from opencv_tpu_torch.core import pyramid as tpyr
from opencv_tpu_torch.core.config import ORBConfig
from opencv_tpu_torch.ops import cuda as cuda_ops
from opencv_tpu_torch.ops import fast as tfast
from opencv_tpu_torch.ops import orb as torb
from opencv_tpu_torch.ops.cuda import fast_kernel as tkernel

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)


def _img(rng, h, w):
    return rng.integers(0, 255, size=(h, w)).astype(np.float32)


@pytest.mark.parametrize("pattern,arc", [(16, 9), (16, 12), (12, 7), (12, 9), (8, 5), (8, 6)])
def test_fast_score_plain_equals_xla(rng, pattern, arc):
    img = _img(rng, 40, 56)
    want = np.asarray(jfast.fast_score(jnp.asarray(img), arc, pattern, use_pallas=False))
    got = tkernel.fast_score_plain(torch.from_numpy(img), arc, pattern).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arc", [9, 12])
def test_fast_score_plain_equals_pallas_interpret(rng, arc):
    img = _img(rng, 40, 140)
    want = np.asarray(jpallas.fast_score_pallas(jnp.asarray(img), arc, strip=8, interpret=True))
    got = tkernel.fast_score_plain(torch.from_numpy(img), arc, 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", [16, 12, 8])
def test_fast_corners_plain_equals_xla(rng, pattern):
    img = _img(rng, 48, 64)
    s_x, c_x = jfast.fast_corners(jnp.asarray(img), 20.0, pattern_size=pattern, use_pallas=False)
    s_t, n_t = tkernel.fast_corners_plain(torch.from_numpy(img), 20.0, pattern_size=pattern)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(n_t.numpy() > -1e8, np.asarray(c_x))


def test_fast_corners_plain_equals_pallas_interpret(rng):
    # flat patches make plateaus of equal scores: the NMS tie-break matters
    img = _img(rng, 64, 140)
    img[10:20, 10:30] = 200.0
    img[30:34, 60:64] = 0.0
    s_p, n_p = jpallas.fast_corners_pallas(jnp.asarray(img), 18.0, strip=16, interpret=True)
    s_t, n_t = tkernel.fast_corners_plain(torch.from_numpy(img), 18.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_p))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_p))


@pytest.mark.parametrize("h,w", [(7, 300), (67, 93)])
def test_fast_corners_wrapper_ragged_equals_xla(rng, h, w):
    # shapes that are no multiple of the CUDA kernel's 32x8 tile
    img = _img(rng, h, w)
    s_x, c_x = jfast.fast_corners(jnp.asarray(img), 15.0, use_pallas=False)
    s_t, n_t = tkernel.fast_corners_cuda(torch.from_numpy(img), 15.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(n_t.numpy() > -1e8, np.asarray(c_x))


def test_kernel_wrapper_takes_one_image():
    with pytest.raises(ValueError):
        tkernel.fast_corners_cuda(torch.zeros((2, 16, 16)), 20.0)
    with pytest.raises(ValueError):
        tkernel.fast_score_cuda(torch.zeros((2, 16, 16)))


def test_fast_detect_matches_jax(checker_image):
    kp_j = jfast.fast_detect(jnp.asarray(checker_image), 200, threshold=15.0, border=8)
    kp_t = tfast.fast_detect(torch.from_numpy(checker_image), 200, threshold=15.0, border=8)
    np.testing.assert_array_equal(kp_t.valid.numpy(), np.asarray(kp_j.valid))
    np.testing.assert_array_equal(kp_t.xy.numpy(), np.asarray(kp_j.xy))
    np.testing.assert_array_equal(kp_t.response.numpy(), np.asarray(kp_j.response))


def test_plain_path_counts_no_launch(rng):
    cuda_ops.reset_launch_counts()
    img = torch.from_numpy(_img(rng, 24, 24))
    tfast.fast_corners(img, 20.0)
    tfast.fast_score(img)
    assert cuda_ops.launch_counts["fast_corners"] == 0
    assert cuda_ops.launch_counts["fast_score"] == 0


def test_kernel_wrapper_refuses_non_cuda_device():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError):
        tkernel.fast_corners_cuda(img, 20.0)


def test_fast_corners_levels_plain_equals_one_level(rng):
    # ragged shapes, and more levels than one launch's table holds
    shapes = [(67, 93), (5, 300), (7, 7), (1, 1)] + [(9, 10 + i) for i in range(tkernel.MAX_LEVELS)]
    levels = [torch.from_numpy(_img(rng, h, w)) for h, w in shapes]
    got = tkernel.fast_corners_levels(levels, 20.0)
    assert len(got) == len(levels)
    for lvl, (s_t, n_t) in zip(levels, got):
        s_p, n_p = tkernel.fast_corners_plain(lvl, 20.0)
        assert torch.equal(s_t, s_p) and torch.equal(n_t, n_p)


@pytest.mark.parametrize("pattern", [16, 12, 8])
def test_fast_corners_levels_equal_xla_on_checker_pyramid(checker_image, pattern):
    pyr = tpyr.build_pyramid(torch.from_numpy(checker_image), 8, 1.2)
    got = tfast.fast_corners_levels(pyr.levels, 20.0, pattern_size=pattern)
    assert len(got) == 8
    for lvl, (s_t, c_t) in zip(pyr.levels, got):
        s_x, c_x = jfast.fast_corners(jnp.asarray(lvl.numpy()), 20.0, pattern_size=pattern,
                                      use_pallas=False)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_x))
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_x))


def test_levels_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tkernel.fast_corners_levels([], 20.0)
    with pytest.raises(ValueError):
        tkernel.fast_corners_levels([torch.zeros((16, 16)), torch.zeros((2, 16, 16))], 20.0)
    with pytest.raises(ValueError):
        tkernel.fast_corners_levels([torch.zeros((16, 16)), torch.zeros((0, 16))], 20.0)
    with pytest.raises(ValueError):
        tkernel.fast_corners_levels([torch.zeros((16, 16)), torch.zeros((16, 16), device="meta")],
                                    20.0)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        tkernel.fast_corners_levels([torch.zeros((16, 16), device="meta")], 20.0)


def test_levels_plain_path_counts_no_launch(rng):
    cuda_ops.reset_launch_counts()
    tfast.fast_corners_levels([torch.from_numpy(_img(rng, 24, 24))] * 3, 20.0)
    assert cuda_ops.launch_counts["fast_corners"] == 0


@pytest.mark.parametrize("n_features,n_used", [(400, 8), (5, 5)])
def test_orb_calls_fast_once_for_the_levels_with_a_budget(monkeypatch, checker_image,
                                                          n_features, n_used):
    calls = []
    real = tfast.fast_corners_levels

    def spy(levels, *args, **kwargs):
        calls.append([tuple(lvl.shape) for lvl in levels])
        return real(levels, *args, **kwargs)

    monkeypatch.setattr(tfast, "fast_corners_levels", spy)
    img = torch.from_numpy(checker_image)
    cfg = ORBConfig(n_features=n_features)
    kp, desc = torb.detect_and_compute(img, cfg)
    budgets = torb.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    pyr = tpyr.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    assert sum(b > 0 for b in budgets) == n_used
    assert calls == [[tuple(pyr.levels[i].shape) for i in range(8) if budgets[i] > 0]]
    assert kp.xy.shape[0] == desc.shape[0] == sum(budgets)
