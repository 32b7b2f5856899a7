"""Connected components, the blob detector and the circles-grid detector
of the PyTorch port against the JAX package on the CPU.

Tolerance: none. Labels are integers that converge to each component's
minimum linear index + 1 however many sweeps run; blob areas, centroid
sums and perimeter counts are integer-valued f32 sums (exact), so the
centroids are the same f32 divisions; the circles grid's lattice code is
the JAX package's host numpy on equal centroids. Everything is asserted
bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import ccomp as jcc
from opencv_tpu.ops.chessboard import find_circles_grid as j_find_circles_grid
from opencv_tpu_torch.ops import ccomp as tcc
from opencv_tpu_torch.ops.chessboard import find_circles_grid

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_msseg_circles import _grid_image


def _two_regions():
    mask = np.zeros((12, 12), bool)
    mask[2:5, 2:5] = True
    mask[7:10, 7:11] = True
    return mask


def _snake():
    """tests/test_ccomp.py's winding 1-px path: many sweeps to converge."""
    mask = np.zeros((10, 20), bool)
    mask[1, 1:18] = True
    mask[1:8, 17] = True
    mask[7, 3:18] = True
    mask[3:8, 3] = True
    return mask


def _random(rng):
    return rng.random((60, 80)) > 0.55


def _diagonal():
    mask = np.zeros((6, 6), bool)
    mask[1, 1] = mask[2, 2] = True
    return mask


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", ["two_regions", "snake", "random", "diagonal"])
def test_labels_equal_jax(rng, name, connectivity):
    mask = {"two_regions": _two_regions, "snake": _snake, "random": lambda: _random(rng),
            "diagonal": _diagonal}[name]()
    got = tcc.connected_components(mask, connectivity, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcc.connected_components(jnp.asarray(mask), connectivity)))


def test_sweeps_and_host_reads(rng):
    """One host read per 16 sweeps; the snake needs more than one read."""
    lab = tcc.connected_components_stats(torch.from_numpy(_snake()), 8)
    assert lab.sweeps == 16 * lab.host_reads and lab.host_reads >= 2
    assert len(np.unique(lab.labels.numpy()[_snake()])) == 1


def _disks():
    img = np.full((80, 100), 200.0, np.float32)
    yy, xx = np.mgrid[0:80, 0:100]
    for cy, cx, r in ((20, 25, 6), (55, 70, 9), (60, 15, 3)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 30.0
    img[5:7, 85:87] = 30.0  # area 4
    img[30:40, 40:60] = 30.0  # a bar: low circularity
    return img


@pytest.mark.parametrize("kw", [dict(threshold=100.0, min_area=20.0),
                                dict(threshold=100.0, min_area=3.0, min_circularity=0.5),
                                dict(threshold=100.0, dark_blobs=False, max_area=1e5),
                                dict(threshold=100.0, min_area=3.0, max_blobs=2)])
def test_detect_blobs_equal_jax(kw):
    img = _disks()
    got = tcc.detect_blobs(img, device="cpu", **kw)
    want = jcc.detect_blobs(jnp.asarray(img), **kw)
    assert got.valid.any()
    for name in ("xy", "area", "circularity", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("jitter,angle", [(0.8, 0.0), (0.0, 0.2)])
def test_find_circles_grid_equal_jax(rng, jitter, angle):
    img, truth = _grid_image(5, 4, rng=rng, jitter=jitter, angle=angle)
    got, ok = find_circles_grid(img, (5, 4), device="cpu")
    want, ok_j = j_find_circles_grid(jnp.asarray(img), (5, 4))
    assert ok == ok_j
    np.testing.assert_array_equal(got, np.asarray(want))
    if ok:
        assert np.linalg.norm(got[:, None] - truth[None], axis=-1).min(axis=1).max() < 2.0


def test_find_circles_grid_reports_failure(rng):
    img = np.full((80, 100), 200.0, np.float32) + rng.normal(0, 3, (80, 100)).astype(np.float32)
    pts, ok = find_circles_grid(img, (5, 4), device="cpu")
    assert not ok and pts.shape == (20, 2)
    assert not j_find_circles_grid(jnp.asarray(img), (5, 4))[1]
