"""The port's panorama (opencv_tpu_torch/examples/panorama.py) against the
JAX package's examples/panorama.py on the CPU.

The views: the port's renderer equals the JAX example's calls (its
resize, Rodrigues and warp) bit for bit. The port's `main()` runs here in
tier 1 and must give its own verdict (a finite focal, a tree spanning the
three views, the image written) with the focal within 15 px of the true
200. The JAX example takes over a minute on a CPU, so the comparison with
its printed figures is `slow`: the same confident pairs and tree, each
focal within 15 px of the truth (JAX's own is 10.9 off). The RANSACs draw
from different generators, so the canvas size may differ by a few px
(the panorama's gauge is free).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.geometry.rotation import rodrigues as jrod
from _jax_examples import parse_panorama, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import panorama as app


def test_views_equal_the_example():
    rng = np.random.default_rng(3)  # examples/panorama.py:34-49
    ts, span = 720, 1.8
    tex = rng.uniform(30, 225, (ts // 8, ts // 8)).astype(np.float32)
    tex = np.asarray(jimg.resize_bilinear(jnp.asarray(tex), ts, ts))
    S = np.array([[ts / (2 * span), 0, ts / 2], [0, ts / (2 * span), ts / 2], [0, 0, 1]])
    K = np.array([[app.F, 0, app.W / 2], [0, app.F, app.H / 2], [0, 0, 1]])
    got = app.render_views("cpu")
    for view, yaw in zip(got, (-0.45, 0.0, 0.45)):
        R = np.asarray(jrod(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
        M = S @ np.linalg.inv(K @ R)
        want = np.asarray(jimg.warp_perspective(jnp.asarray(tex), jnp.asarray(M, jnp.float32),
                                                app.H, app.W))
        np.testing.assert_array_equal(view.numpy(), want)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pano") / "panorama.png"
    return app.main(["--cpu", "--out", str(out)]), out


def test_port_app_verdict(port_run):
    got, out = port_run
    assert got["ok"] and out.exists()
    assert abs(got["focal"] - app.F) <= 15.0
    assert len(got["tree"]) == 2 and got["pairs"] >= 2


@pytest.mark.slow
def test_figures_match_the_jax_example(port_run, tmp_path):
    want = parse_panorama(run_jax_example("panorama", [], tmp_path, timeout=600))
    got, _ = port_run
    assert (tmp_path / "panorama.png").exists()
    assert got["pairs"] == want["pairs"] and got["tree"] == want["tree"]
    assert abs(got["focal"] - app.F) <= 15.0 and abs(want["focal"] - app.F) <= 15.0
