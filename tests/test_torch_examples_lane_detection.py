"""The port's lane_detection (opencv_tpu_torch/examples/lane_detection.py)
against the JAX package's examples/lane_detection.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`); the
port's `main()` must find the same number of segments and the same lanes
(the port's chip-check bounds), and here, where both run on a CPU, the
same number of edge pixels. The road is numpy in both: the port's equals
the example's.
"""

import numpy as np

from chip_smoke import JAX_FIGURES_SLICE13
from _jax_examples import parse_lane_detection, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import lane_detection


def test_road_equals_the_example():
    rng = np.random.default_rng(0)  # examples/lane_detection.py:39-44
    img = rng.uniform(20, 60, size=(240, 320)).astype(np.float32)
    lane_detection.draw_line(img, 80, 230, 150, 120)
    lane_detection.draw_line(img, 260, 230, 180, 120)
    np.testing.assert_array_equal(lane_detection.road(), img)


def test_figures_match_the_jax_example(tmp_path, capsys):
    want = parse_lane_detection(run_jax_example("lane_detection", [], tmp_path, timeout=300))
    got = lane_detection.main(["--cpu"])
    assert parse_lane_detection(capsys.readouterr().out) == want
    assert (got["segments"], got["left"], got["right"]) == (want["segments"], want["left"], want["right"])
    assert got["edge_px"] == want["edge_px"]
    assert got["ok"] and want["left"] and want["right"]
    assert JAX_FIGURES_SLICE13["lane_detection"] == want  # chip_smoke's copy (tools/jax_slice13_figures.py)
