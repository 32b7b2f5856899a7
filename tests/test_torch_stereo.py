"""Stereo depth of the PyTorch port (block matching, SGBM, BP, CSBP,
reprojection) against the JAX package on the CPU, on the seeded 64x96
pair of tests/test_stereo_bp.py (background 4 px, a block at 10 px).

Tolerances:
- BM: none. SAD box sums in eager JAX's prefix-sum order, argmin and
  gates op for op: disparities equal (NaN where both are NaN).
- SGBM: >= 99.5 % of pixels equal and the rest within 1 px. The costs
  and the path recursions are additions and minima in the JAX function's
  order; its `lax.scan` bodies are compiled, which may fuse differently.
- BP and CSBP: >= 99 % of pixels equal. Messages are normalised by their
  mean over the disparities, a sum whose order is the library's, and
  argmin over near-equal beliefs can flip.
- CSBP's plane choice: on a cost volume full of ties the port picks the
  same planes in the same order as `lax.top_k(-cost)`.
- reproject_to_3d: within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from opencv_tpu.ops import sgbm as jsgbm
from opencv_tpu.ops import stereo as jstereo
from opencv_tpu.ops import stereo_bp as jbp
from opencv_tpu_torch.ops import sgbm, stereo, stereo_bp

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_stereo_bp import _synthetic_pair


@pytest.fixture(scope="module")
def pair():
    return _synthetic_pair(np.random.default_rng(1234))


def test_bm_equal(pair):
    left, right, _ = pair
    want = np.asarray(jstereo.compute_disparity_bm(jnp.asarray(left), jnp.asarray(right),
                                                   num_disparities=16, block_size=9))
    got = stereo.compute_disparity_bm(left, right, num_disparities=16, block_size=9,
                                      device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).mean() > 0.5


@pytest.mark.parametrize("num_paths", [8, 4])
def test_sgbm_agrees(pair, num_paths):
    left, right, _ = pair
    jcfg = jsgbm.SGBMConfig(num_disparities=16, num_paths=num_paths)
    cfg = sgbm.SGBMConfig(num_disparities=16, num_paths=num_paths)
    want = np.asarray(jsgbm.compute_disparity_sgbm(jnp.asarray(left), jnp.asarray(right), jcfg))
    got = sgbm.compute_disparity_sgbm(left, right, cfg, device="cpu").numpy()
    same = got == want
    assert same.mean() >= 0.995, same.mean()
    assert np.abs(got - want).max() <= 1.0
    assert (want >= 0).mean() > 0.5


def test_sgbm_cost_volume_and_speckles(pair):
    left, right, _ = pair
    jcfg = jsgbm.SGBMConfig(num_disparities=16)
    cfg = sgbm.SGBMConfig(num_disparities=16)
    want = np.asarray(jsgbm.cost_volume(jnp.asarray(left), jnp.asarray(right), jcfg))
    got = sgbm.cost_volume(torch.from_numpy(left), torch.from_numpy(right), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    disp = rng.integers(0, 6, (40, 60)).astype(np.float32)
    disp[5:20, 5:30] = 9.0
    disp[rng.random((40, 60)) < 0.2] = -1.0
    want = np.asarray(jsgbm.filter_speckles(jnp.asarray(disp), -1.0, 30, 1.0))
    got = sgbm.filter_speckles(torch.from_numpy(disp), -1.0, 30, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_bp_agrees(pair):
    left, right, _ = pair
    want = np.asarray(jbp.stereo_bp(jnp.asarray(left), jnp.asarray(right), num_disparities=16,
                                    n_iters=6, n_levels=3))
    got = stereo_bp.stereo_bp(left, right, num_disparities=16, n_iters=6, n_levels=3,
                              device="cpu").numpy()
    assert (got == want).mean() >= 0.99, (got == want).mean()


def test_csbp_agrees(pair):
    left, right, _ = pair
    want = np.asarray(jbp.stereo_csbp(jnp.asarray(left), jnp.asarray(right), num_disparities=16,
                                      nr_plane=6, n_iters=8))
    got = stereo_bp.stereo_csbp(left, right, num_disparities=16, nr_plane=6, n_iters=8,
                                device="cpu").numpy()
    assert (got == want).mean() >= 0.99, (got == want).mean()


def test_csbp_planes_tie_order():
    """Costs quantised to a few levels: most pixels have tied disparities
    at the cut, where the lower disparity must come first."""
    rng = np.random.default_rng(7)
    cost = rng.integers(0, 3, (12, 16, 16)).astype(np.float32)
    neg, want_planes = lax.top_k(-jnp.asarray(cost), 6)
    vals, planes = stereo_bp.csbp_planes(torch.from_numpy(cost), 6)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want_planes))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_reproject_to_3d(pair):
    left, right, _ = pair
    disp = np.asarray(jstereo.compute_disparity_bm(jnp.asarray(left), jnp.asarray(right),
                                                   num_disparities=16, block_size=9))
    disp = np.nan_to_num(disp, nan=-1.0)
    want = np.asarray(jstereo.reproject_to_3d(jnp.asarray(disp), 500.0, 0.1, 48.0, 32.0))
    got = stereo.reproject_to_3d(torch.from_numpy(disp), 500.0, 0.1, 48.0, 32.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
