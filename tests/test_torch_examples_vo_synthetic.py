"""The port's vo_synthetic (opencv_tpu_torch/examples/vo_synthetic.py)
against the JAX package's examples/vo_synthetic.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`, 8 frames
with `--frames 8`). The engines draw their RANSAC subsets from different
generators (JAX's PRNG, a torch.Generator), so the two trajectories are
held under the app's own bound: ATE below 5 % of the path for each, the
JAX figure beside the port's; the path lengths equal (one scene). The
frames: the port's renderer equals the JAX example's calls (its Rodrigues
and Gaussian blur) bit for bit.
"""

import jax.numpy as jnp
import numpy as np

from opencv_tpu.core import imgproc as jimg
from opencv_tpu.geometry.rotation import rodrigues as jrod
from _jax_examples import parse_vo_synthetic, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import vo_synthetic as app

ARGS = ["--frames", "8"]


def _jax_render(world, inten, rvec, tvec):
    """examples/vo_synthetic.py:34-52."""
    H, W, F = app.H, app.W, app.F
    R = np.asarray(jrod(jnp.asarray(rvec, jnp.float32)))
    pc = world @ R.T + tvec
    z = pc[:, 2]
    vis = z > 0.5
    u = F * pc[:, 0] / z + W / 2
    v = F * pc[:, 1] / z + H / 2
    vis &= (u >= 2) & (u < W - 2) & (v >= 2) & (v < H - 2)
    img = np.zeros((H, W), np.float32)
    uf, vf = u[vis], v[vis]
    u0, v0 = np.floor(uf).astype(int), np.floor(vf).astype(int)
    au, av = uf - u0, vf - v0
    ii = inten[vis]
    np.add.at(img, (v0, u0), ii * (1 - au) * (1 - av))
    np.add.at(img, (v0, u0 + 1), ii * au * (1 - av))
    np.add.at(img, (v0 + 1, u0), ii * (1 - au) * av)
    np.add.at(img, (v0 + 1, u0 + 1), ii * au * av)
    img = np.asarray(jimg.gaussian_blur(jnp.asarray(img), 5, 1.1))
    return np.clip(img * 4.0, 0, 255)


def test_frames_equal_the_example():
    world, inten = app.scene()
    for i in (0, 7, 19):
        c = np.array([0.12 * i, 0.0, 0.05 * i], np.float32)  # examples/vo_synthetic.py:79-83
        rvec = np.array([0.0, np.deg2rad(0.3 * i), 0.0], np.float32)
        tvec = (-np.asarray(jrod(jnp.asarray(rvec))) @ c).astype(np.float32)
        got_c, got_rvec, got_tvec = app.pose(i)
        np.testing.assert_array_equal(got_c, c)
        np.testing.assert_array_equal(got_tvec, tvec)
        np.testing.assert_array_equal(app.render(world, inten, got_rvec, got_tvec, "cpu"),
                                      _jax_render(world, inten, rvec, tvec))


def test_trajectory_within_the_apps_bound_beside_jax(tmp_path, capsys):
    want = parse_vo_synthetic(run_jax_example("vo_synthetic", ARGS, tmp_path, timeout=300))
    got = app.main(ARGS + ["--cpu"])
    printed = parse_vo_synthetic(capsys.readouterr().out)
    assert len(printed["frames"]) == len(got["frames"]) == len(want["frames"]) == 8
    assert abs(got["path"] - want["path"]) <= 5e-4  # printed to 3 decimals
    print(f"ATE: port {got['ate']:.4f}, JAX {want['ate']:.4f}, path {got['path']:.3f}")
    assert want["ate"] < 0.05 * want["path"]
    assert got["ate"] < 0.05 * got["path"] and got["ok"]
    assert got["state"] == want["frames"][-1]["state"] == "tracking"
