"""The port's qr_demo (opencv_tpu_torch/examples/qr_demo.py) against the
JAX package's examples/qr_demo.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`); the
port's `main()` must decode the same text and find the quad within
0.5 px (the port's chip-check bounds; the JAX example prints it to 0.1
px). The port's scene equals the JAX package's encoder and renderer on
the example's seed.
"""

import numpy as np

from opencv_tpu.ops import qrcode as jqr
from chip_smoke import JAX_FIGURES_SLICE13
from _jax_examples import parse_qr_demo, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import qr_demo


def test_scene_equals_the_example():
    mat = jqr.encode_qr("opencv_tpu says hi", version=2)  # examples/qr_demo.py:26-31
    img = jqr.render_qr(mat, module_px=5)
    rng = np.random.default_rng(0)
    scene = np.full((300, 340), 190.0, np.float32)
    scene[70:70 + img.shape[0], 90:90 + img.shape[1]] = img
    scene += rng.normal(0, 6.0, scene.shape).astype(np.float32)
    np.testing.assert_array_equal(qr_demo.scene("opencv_tpu says hi"), scene)


def test_figures_match_the_jax_example(tmp_path, capsys):
    want = parse_qr_demo(run_jax_example("qr_demo", [], tmp_path, timeout=300))
    got = qr_demo.main(["--cpu"])
    assert parse_qr_demo(capsys.readouterr().out)["text"] == got["text"] == want["text"]
    assert got["detected"] and want["detected"] and got["ok"] and want["ok"]
    assert np.abs(np.asarray(got["quad"]) - np.asarray(want["quad"])).max() <= 0.5
    assert JAX_FIGURES_SLICE13["qr_demo"] == want  # chip_smoke's copy (tools/jax_slice13_figures.py)


def test_another_text_round_trips():
    got = qr_demo.main(["--cpu", "--text", "port 123"])
    assert got["ok"] and got["text"] == "port 123"
