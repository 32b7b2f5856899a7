"""The port's tbd_app (opencv_tpu_torch/examples/tbd_app.py) against the
JAX package's examples/tbd_app.py on the CPU.

The JAX example runs as its users run it (a subprocess, `--cpu`); its
printed figures are held to the port's `main()` under the bounds of the
port's chip check: TP, FP and FN equal, MOTA and MOTP within 1e-3 (the
JAX example prints three decimals). Both run 30 frames (`--frames 30`).
The scene is numpy in both: the port's boxes equal the example's.
"""

import numpy as np
import pytest

from _jax_examples import parse_tbd_app, run_jax_example
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)
from opencv_tpu_torch.examples import tbd_app

ARGS = ["--frames", "30"]


def test_gt_boxes_equal_the_example():
    for t in (0, 17, 59):  # examples/tbd_app.py:50-66
        peds = np.array([[20 + 3.0 * t, 40 + 0.5 * t, 14, 30], [300 - 2.5 * t, 60, 14, 30],
                         [40 + 2.0 * t, 120, 14, 30]], np.float32)
        vehicles = np.array([[10 + 6.0 * t, 200, 40, 24], [500 - 5.0 * t, 230, 44, 26]], np.float32)
        got = tbd_app.gt_boxes(t)
        np.testing.assert_array_equal(got[0], peds)
        np.testing.assert_array_equal(got[1], vehicles)


def test_figures_match_the_jax_example(tmp_path, capsys):
    want = parse_tbd_app(run_jax_example("tbd_app", ARGS, tmp_path, timeout=300))
    got = tbd_app.main(ARGS + ["--cpu"])
    assert parse_tbd_app(capsys.readouterr().out)["ok"] == got["ok"] == want["ok"] is True
    for cls in ("pedestrians", "vehicles"):
        g, w = got[cls], want[cls]
        assert (g["tp"], g["fp"], g["fn"]) == (w["tp"], w["fp"], w["fn"]), cls
        assert abs(g["mota"] - w["mota"]) <= 1e-3 and abs(g["motp"] - w["motp"]) <= 1e-3, (cls, g, w)


def test_history_distribution_is_normalised():
    np.testing.assert_allclose(tbd_app.history_distribution("7,3"), [0.7, 0.3])
    with pytest.raises(SystemExit):
        tbd_app.build_parser().parse_args(["--frames", "x"])
