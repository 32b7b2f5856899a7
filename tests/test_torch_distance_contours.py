"""Distance transform, flood fill, mean shift and contours of the PyTorch
port against the JAX package on the CPU.

Tolerances.
- distance_transform: minima of sums of integers, then one sqrt: equal.
- flood_fill and mean_shift_segmentation's labels: fixed points of
  integer propagation (the host reads the flag every few sweeps; the
  extra sweeps change nothing): equal. mean_shift_filter: 0/1-weighted
  sums in the JAX order: equal. The segmentation's region means are
  scatter sums whose order the library chooses: within 1e-4 grey.
- find_contours and the hierarchy, draw_contours, convex_hull,
  approx_poly_dp, min_area_rect, box_points, min_enclosing_circle,
  rotated_rect_intersection, min_enclosing_triangle: the JAX module's
  host numpy, copied: equal.
- Moments, Hu, area, arc length, matchShapes, pointPolygonTest distances:
  f32 reductions in the library's order: relative 1e-5 (moments, Hu,
  area, arc length, distances) and 1e-4 (matchShapes takes logs of the
  Hu invariants). bounding_rect, is_contour_convex and the polygon test's
  signs: equal.
- fit_ellipse: the port solves its 5-unknown least squares by QR in f64,
  JAX by an f32 SVD: centre and axes within 1e-3 px, angle within 0.05
  degrees, on ellipses that are not circles.
- fit_line: a 2x2 covariance product and `eigh`: the direction and point
  within 1e-4, up to the direction's sign (the solver's choice); for
  "l1" the point within 1e-2 px (its IRLS weights 1/r let the point
  nearest the line dominate, so ulps in r move it; measured 5e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.ops import contours as jct
from opencv_tpu.ops import distance as jd
from opencv_tpu_torch.ops import contours as tct
from opencv_tpu_torch.ops import distance as td

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"


def _equal(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rel(a, b, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * max(np.abs(a).max(), 1e-30))


def _shapes_mask(h=60, w=80):
    """An ellipse with a square hole, a bar, a blob inside the hole, a
    rotated ellipse and a one-pixel speck."""
    yy, xx = np.mgrid[:h, :w]
    mask = (xx - 24) ** 2 / 300 + (yy - 24) ** 2 / 150 < 1
    mask[18:30, 18:31] = False
    mask[22:26, 22:26] = True
    mask |= (np.abs(xx - 65) < 5) & (np.abs(yy - 30) < 14)
    u, v = (xx - 30) * 0.8 + (yy - 50) * 0.6, -(xx - 30) * 0.6 + (yy - 50) * 0.8
    mask |= u ** 2 / 120 + v ** 2 / 25 < 1
    mask[2, 76] = True
    return mask


# -------------------------------------------------------------- distance ---

@pytest.mark.parametrize("density", [0.2, 0.95])
def test_distance_transform_equals_jax(rng, density):
    mask = rng.random((40, 56)) < density
    _equal(jd.distance_transform(jnp.asarray(mask)), td.distance_transform(mask, device=CPU))


@pytest.mark.parametrize("seed,lo,up", [((5, 5), 30.0, 30.0), ((40, 20), 0.0, 0.0),
                                        ((10, 30), 60.0, 10.0)])
def test_flood_fill_equals_jax(rng, seed, lo, up):
    img = np.round(rng.uniform(0, 255, (40, 56))).astype(np.float32)
    img[:, 25] = 500.0  # a wall
    jf, jm = jd.flood_fill(jnp.asarray(img), seed, 300.0, lo, up)
    tf, tm = td.flood_fill(img, seed, 300.0, lo, up, device=CPU)
    _equal(jm, tm)
    _equal(jf, tf)


def _blocks(rng, h=30, w=40):
    img = np.kron(rng.uniform(20, 230, (3, 4)), np.ones((10, 10)))[:h, :w]
    return (img + rng.normal(0, 4, (h, w))).astype(np.float32)


def test_mean_shift_filter_equals_jax(rng):
    img = _blocks(rng)
    _equal(jd.mean_shift_filter(jnp.asarray(img), 3, 15.0, 3),
           td.mean_shift_filter(img, 3, 15.0, 3, device=CPU))


def test_mean_shift_segmentation_equals_jax(rng):
    img = _blocks(rng)
    jl, js = jd.mean_shift_segmentation(jnp.asarray(img), 3, 15.0, 20, 3)
    tl, ts = td.mean_shift_segmentation(img, 3, 15.0, 20, 3, device=CPU)
    _equal(jl, tl)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    assert len(np.unique(tl.numpy())) <= 16


# -------------------------------------------------------------- contours ---

@pytest.mark.parametrize("kind", ["shapes", "random", "nested"])
def test_find_contours_equal_jax(rng, kind):
    if kind == "shapes":
        mask = _shapes_mask()
    elif kind == "random":
        mask = rng.random((30, 40)) > 0.6
    else:
        mask = np.zeros((40, 40), bool)
        for r in (18, 12, 6):
            mask[20 - r:20 + r, 20 - r:20 + r] = r != 12
    want = jct.find_contours(mask, max_contours=128)
    got = tct.find_contours(torch.from_numpy(mask), max_contours=128)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(tct.draw_contours(mask.shape, got, 2),
                                  jct.draw_contours(mask.shape, want, 2))
    if kind == "nested":  # outer square, its hole, the inner square: a chain of parents
        n = int(got.valid.sum())
        np.testing.assert_array_equal(got.parent[:n], [-1, 0, 1])
        np.testing.assert_array_equal(got.is_hole[:n], [False, True, False])


def _contours():
    c = jct.find_contours(_shapes_mask())
    n = int(c.valid.sum())
    return [(c.points[i], int(c.lengths[i])) for i in range(n)]


def test_moments_and_descriptors_close_to_jax():
    for pts, k in _contours():
        jm = jct.contour_moments(jnp.asarray(pts), k)
        tm = tct.contour_moments(pts, k, device=CPU)
        for f in jm._fields:
            _rel(getattr(jm, f), getattr(tm, f), 1e-5)
        _rel(jct.hu_moments(jm), tct.hu_moments(tm), 1e-5)
        for oriented in (False, True):
            _rel(jct.contour_area(jnp.asarray(pts), k, oriented),
                 tct.contour_area(pts, k, oriented, device=CPU), 1e-5)
        for closed in (True, False):
            _rel(jct.arc_length(jnp.asarray(pts), k, closed),
                 tct.arc_length(pts, k, closed, device=CPU), 1e-5)
        _equal(jct.bounding_rect(jnp.asarray(pts), k), tct.bounding_rect(pts, k, device=CPU))
        assert bool(jct.is_contour_convex(jnp.asarray(pts), k)) == bool(
            tct.is_contour_convex(pts, k, device=CPU))
    mask = _shapes_mask().astype(np.float32)
    jm, tm = jct.image_moments(jnp.asarray(mask)), tct.image_moments(mask, device=CPU)
    for f in jm._fields:
        _rel(getattr(jm, f), getattr(tm, f), 1e-5)


def test_convexity_of_a_hull_and_a_notch():
    hull = tct.convex_hull(_contours()[0][0])
    assert bool(tct.is_contour_convex(hull, device=CPU))
    notch = np.array([[0, 0], [10, 0], [5, 3], [10, 10], [0, 10]], np.float32)
    assert not bool(tct.is_contour_convex(notch, device=CPU))
    assert bool(jct.is_contour_convex(jnp.asarray(notch))) is False


def test_match_shapes_and_polygon_test_close_to_jax(rng):
    cs = _contours()
    hus = [np.asarray(jct.hu_moments(jct.contour_moments(jnp.asarray(p), k))) for p, k in cs]
    for method in (1, 2, 3):
        _rel(jct.match_shapes(hus[0], hus[2], method), tct.match_shapes(hus[0], hus[2], method,
                                                                         device=CPU), 1e-4)
    pts, k = cs[0]
    q = np.concatenate([rng.uniform(0, 60, (64, 2)), pts[:5]]).astype(np.float32)
    for measure in (False, True):
        want = np.asarray(jct.point_polygon_test(jnp.asarray(pts), jnp.asarray(q), measure, k))
        got = tct.point_polygon_test(pts, q, measure, k, device=CPU).numpy()
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        _rel(want, got, 1e-5)


def _ellipse_pts(cx, cy, a, b, ang_deg, n=50, pad=14):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c, s = np.cos(np.radians(ang_deg)), np.sin(np.radians(ang_deg))
    x, y = a * np.cos(t), b * np.sin(t)
    pts = np.stack([cx + c * x - s * y, cy + s * x + c * y], 1).astype(np.float32)
    return np.concatenate([pts, np.repeat(pts[-1:], pad, 0)]), n


@pytest.mark.parametrize("params", [(30, 20, 12, 5, 30), (64, 40, 25, 9, 110), (10, 50, 6, 3, 75)])
def test_fit_ellipse_close_to_jax(params):
    pts, n = _ellipse_pts(*params)
    jc, ja, jang = jct.fit_ellipse(jnp.asarray(pts), n)
    tc, ta, tang = tct.fit_ellipse(pts, n, device=CPU)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-3)
    assert abs(float(tang) - float(jang)) < 0.05
    np.testing.assert_allclose(tc.numpy(), params[:2], atol=1e-2)
    np.testing.assert_allclose(np.sort(ta.numpy()), [2 * params[3], 2 * params[2]], atol=1e-2)


@pytest.mark.parametrize("dist_type", ["l2", "l1", "l12", "huber", "fair", "welsch"])
def test_fit_line_close_to_jax(rng, dist_type):
    t = rng.uniform(-20, 20, 40)
    pts = np.stack([30 + 0.8 * t, 20 + 0.6 * t], 1) + rng.normal(0, 0.3, (40, 2))
    pts[:4] += rng.normal(0, 8, (4, 2))  # outliers
    pts = np.concatenate([pts, np.zeros((8, 2))]).astype(np.float32)
    want = np.asarray(jct.fit_line(jnp.asarray(pts), 40, dist_type))
    got = tct.fit_line(pts, 40, dist_type, device=CPU).numpy()
    got[:2] *= np.sign(got[:2] @ want[:2])
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-4)
    np.testing.assert_allclose(got[2:], want[2:], atol=1e-2 if dist_type == "l1" else 1e-4)


def test_host_shapes_equal_jax(rng):
    pts = rng.uniform(0, 50, (40, 2)).astype(np.float32)
    for cw in (False, True):
        np.testing.assert_array_equal(tct.convex_hull(pts, cw), jct.convex_hull(pts, cw))
    cont = _contours()[0][0][: _contours()[0][1]]
    for closed in (True, False):
        np.testing.assert_array_equal(tct.approx_poly_dp(cont, 1.5, closed),
                                      jct.approx_poly_dp(cont, 1.5, closed))
    for got, want in zip(tct.min_area_rect(pts), jct.min_area_rect(pts)):
        np.testing.assert_array_equal(got, want)
    rect = jct.min_area_rect(pts)
    np.testing.assert_array_equal(tct.box_points(*rect), jct.box_points(*rect))
    for got, want in zip(tct.min_enclosing_circle(pts), jct.min_enclosing_circle(pts)):
        np.testing.assert_array_equal(got, want)
    r1, r2 = ((10.0, 10.0), (8.0, 4.0), 20.0), ((12.0, 11.0), (6.0, 6.0), -35.0)
    (s1, p1), (s2, p2) = tct.rotated_rect_intersection(r1, r2), jct.rotated_rect_intersection(r1, r2)
    assert s1 == s2 == tct.INTERSECT_PARTIAL
    np.testing.assert_array_equal(p1, p2)
    tri_t, area_t = tct.min_enclosing_triangle(pts[:12])
    tri_j, area_j = jct.min_enclosing_triangle(pts[:12])
    np.testing.assert_array_equal(tri_t, tri_j)
    assert area_t == area_j
