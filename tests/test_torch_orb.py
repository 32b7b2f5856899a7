"""ORB front end of the PyTorch port against the JAX package on the CPU.

Measured on these inputs (integer-valued images): pyramid level 0 and
every blurred level are bit-exact; bilinear levels >= 1 are exact or
differ by at most 2 ulp (XLA contracts the two-tap sum into an FMA on
some pixels); the Harris response sums its blocks in eager JAX's
prefix-sum order and is bit-equal to the eager JAX function; angles
differ by < 3e-4 rad and keypoint responses by < 1e-2 relative where
they cancel toward zero (the levels' ulps); keypoint positions,
validity and levels are equal; descriptors agree on 100% of bits. The
bounds asserted below are looser than what was measured only where a
rounding could flip a tap: <= 4 ulp on levels, >= 99.5% equal
descriptor bits, >= 98% equal keypoint positions on rendered frames.
On real video (benchmarks/data/megamind_gray.avi, frames 100 and 149 at
2000 features) every slot is held: the same valid mask, levels and
descriptor bits, positions within 1e-4 px (sub-pixel refinement of
levels that differ by an ulp; measured <= 7.7e-5), responses at rtol
1e-2 (measured <= 7.5e-3).
"""

import pathlib

import numpy as np
import jax.numpy as jnp
import jax
import pytest
import torch

from opencv_tpu.core import imgproc as jimg, pyramid as jpyr
from opencv_tpu.core.config import ORBConfig as JORBConfig
from opencv_tpu.core.types import masked_top_k as j_masked_top_k
from opencv_tpu.ops import orb as jorb
from opencv_tpu_torch.core import imgproc as timg, pyramid as tpyr
from opencv_tpu_torch.core.config import ORBConfig
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.ops import orb as torb

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_vo import render_frame


def test_brief_pattern_equals_jax():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


def test_masked_top_k_matches_lax_top_k_on_ties(rng):
    vals = rng.integers(0, 40, size=5000).astype(np.float32)  # many ties
    valid = rng.random(5000) > 0.3
    ij, kj = j_masked_top_k(jnp.asarray(vals), jnp.asarray(valid), 700)
    it, kt = masked_top_k(torch.from_numpy(vals), torch.from_numpy(valid), 700)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


def _frame():
    rng = np.random.default_rng(5)
    n = 900
    world = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n),
                      7.0 + rng.uniform(-1, 1, n)], 1).astype(np.float32)
    inten = rng.uniform(60, 255, n).astype(np.float32)
    return np.round(render_frame(world, inten, np.zeros(3, np.float32),
                                 np.zeros(3, np.float32))).astype(np.float32)


@pytest.fixture(scope="module")
def images(checker_image):
    return {"checker": np.round(checker_image), "frame": _frame()}


@pytest.mark.parametrize("name", ["checker", "frame"])
def test_pyramid_and_blur_levels(images, name):
    img = images[name]
    # op by op, as the XLA path of the JAX package defines the levels
    # (under jit the interpolation einsums move some pixels by ~1e-3)
    jp = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    tp = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    np.testing.assert_array_equal(tp.levels[0].numpy(), np.asarray(jp.levels[0]))
    for a, b in zip(jp.levels, tp.levels):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=4 * np.spacing(np.float32(255)))
        # blurred levels from equal inputs equal the op-by-op JAX blur bit
        # for bit (under jit XLA contracts the tap sums into FMAs and moves
        # ~30 % of pixels by 1 ulp; detect_and_compute below meets that)
        np.testing.assert_array_equal(
            timg.gaussian_blur(torch.from_numpy(a.copy()), 7, 2.0).numpy(),
            np.asarray(jimg.gaussian_blur(jnp.asarray(a), 7, 2.0)),
        )


@pytest.mark.parametrize("name", ["checker", "frame"])
def test_detect_and_compute_matches_jax(images, name):
    img = images[name]
    kj, dj = jax.jit(lambda x: jorb.detect_and_compute(x, JORBConfig(n_features=400)))(
        jnp.asarray(img))
    kt, dt = torb.detect_and_compute(torch.from_numpy(img), ORBConfig(n_features=400))
    vj = np.asarray(kj.valid)
    vt = kt.valid.numpy()
    assert vt.sum() > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
    same_xy = np.all(np.abs(kt.xy.numpy() - np.asarray(kj.xy)) < 1e-4, axis=1)[vj]
    assert same_xy.mean() >= 0.98
    np.testing.assert_allclose(kt.angle.numpy()[vj], np.asarray(kj.angle)[vj], atol=1e-3)
    # responses of levels >= 1 that differ by an ulp: measured <= 3e-4 relative
    np.testing.assert_allclose(kt.response.numpy()[vj], np.asarray(kj.response)[vj], rtol=1e-3)
    bits_t = np.unpackbits(dt.numpy().view(np.uint8)[vt])
    bits_j = np.unpackbits(np.asarray(dj).view(np.uint8)[vj])
    assert (bits_t == bits_j).mean() >= 0.995


def test_harris_and_angles_close(images):
    img = images["frame"]
    hj = np.asarray(jimg.harris_response(jnp.asarray(img)))
    ht = timg.harris_response(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ht, hj)
    aj = np.asarray(jorb.ic_angle_maps(jnp.asarray(img)))
    at = torb.ic_angle_maps(torch.from_numpy(img)).numpy()
    # atan2 of moments summed in another order: compare where the moments
    # are not both ~0 (flat black background)
    strong = np.abs(at) > 0
    d = np.angle(np.exp(1j * (at - aj)))
    assert np.median(np.abs(d[strong])) < 1e-5


def test_shift2d_and_nms_2d_equal_jax(rng):
    # integer scores: plateaus make the tie-break decide
    score = rng.integers(0, 6, size=(40, 52)).astype(np.float32)
    for dy, dx in ((2, -3), (-1, 0), (0, 4)):
        np.testing.assert_array_equal(
            timg.shift2d(torch.from_numpy(score), dy, dx, 7.0).numpy(),
            np.asarray(jimg.shift2d(jnp.asarray(score), dy, dx, 7.0)))
    for radius in (1, 2):
        np.testing.assert_array_equal(
            timg.nms_2d(torch.from_numpy(score), radius).numpy(),
            np.asarray(jimg.nms_2d(jnp.asarray(score), radius)))


def test_pose_record_equals_jax(rng):
    from opencv_tpu.core.types import Pose as JPose
    from opencv_tpu.geometry.rotation import rodrigues as jrod
    from opencv_tpu_torch.core.types import Pose

    Rs = [np.asarray(jrod(jnp.asarray(rng.normal(0, 0.5, 3).astype(np.float32)))) for _ in range(2)]
    ts = [rng.normal(size=3).astype(np.float32) for _ in range(2)]
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    a, b = (JPose(R=jnp.asarray(R), t=jnp.asarray(t)) for R, t in zip(Rs, ts))
    c, d = (Pose(R=torch.from_numpy(R), t=torch.from_numpy(t)) for R, t in zip(Rs, ts))
    for pj, pt in ((a.compose(b), c.compose(d)), (a.inverse(), c.inverse()),
                   (JPose.identity(), Pose.identity())):
        np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-6)
        np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-6)
    np.testing.assert_allclose(c.apply(torch.from_numpy(pts)).numpy(),
                               np.asarray(a.apply(jnp.asarray(pts))), atol=1e-5)


@pytest.fixture(scope="module")
def megamind():
    from opencv_tpu.io.video import read_mjpeg_avi

    return read_mjpeg_avi(str(pathlib.Path(__file__).resolve().parents[1]
                              / "benchmarks" / "data" / "megamind_gray.avi"))


def test_detect_and_compute_on_real_video_matches_jax(megamind):
    """Frames 100 and 149 at 2000 features: Harris ranks the candidates, so
    its block sums must follow JAX's order for the slots to agree (with
    torch.cumsum two slots per frame swapped)."""
    assert megamind.shape == (150, 528, 720)
    cfg_j, cfg_t = JORBConfig(n_features=2000), ORBConfig(n_features=2000)
    run_j = jax.jit(lambda x: jorb.detect_and_compute(x, cfg_j))
    for f in (100, 149):
        img = megamind[f].astype(np.float32)
        kj, dj = run_j(jnp.asarray(img))
        kt, dt = torb.detect_and_compute(torch.from_numpy(img), cfg_t)
        vj = np.asarray(kj.valid)
        assert vj.sum() > 1000
        np.testing.assert_array_equal(kt.valid.numpy(), vj)
        np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
        np.testing.assert_allclose(kt.xy.numpy()[vj], np.asarray(kj.xy)[vj], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(dt.numpy().view(np.uint32)[vj], np.asarray(dj)[vj])
        np.testing.assert_allclose(kt.response.numpy()[vj], np.asarray(kj.response)[vj], rtol=1e-2)
