"""The JAX package's own [bgfg] figures on chip_smoke.py's scene, on the CPU.

    python tools/jax_slice9_figures.py

chip_smoke.py's `[bgfg]` line prints the port's box recall and precision
(IoU >= 0.5, frames 20-119) beside the JAX package's on the same scene:
`bgfg_scene()` (crowd_gt()'s 40 boxes at fixed grey levels over the
scene's frame 0, N(0, 2) noise, 120 frames of 480x640). This script runs
the JAX package's MOG2 (MOG2Config() defaults, from the empty frame),
morphology_open(3), find_contours, contour_area and bounding_rect on it
and prints the dictionary that chip_smoke.py keeps as
`JAX_FIGURES_SLICE9`. The machine with the card has no JAX. Takes about
a minute (eager JAX).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opencv_tpu.ops import bgsegm, contours, morphology  # noqa: E402


def jax_boxes(mask) -> np.ndarray:
    """chip_smoke.bgfg_boxes with the JAX package's functions (padded
    contours with their lengths: one compiled shape)."""
    opened = np.asarray(morphology.morphology_open(mask.astype(jnp.float32), 3)) > 0
    c = contours.find_contours(opened)
    out = []
    for i in range(c.points.shape[0]):
        if not c.valid[i] or c.is_hole[i]:
            continue
        pts, n = jnp.asarray(c.points[i]), int(c.lengths[i])
        if float(contours.contour_area(pts, n)) >= cs.BGFG_MIN_AREA:
            out.append(np.asarray(contours.bounding_rect(pts, n)))
    return np.asarray(out, np.int64).reshape(-1, 4)


def main():
    t0 = time.perf_counter()
    frames, _, _ = cs.make_sequence(1, device="cpu")
    scene, gt = cs.bgfg_scene(frames[0])
    state = bgsegm.init_state(jnp.asarray(scene[0]))
    dets = []
    for t in range(1, scene.shape[0]):
        state, fg = bgsegm.apply(state, jnp.asarray(scene[t]))
        dets.append(jax_boxes(fg))
    recall, precision = cs.recall_precision(dets, gt)
    print(json.dumps({"bgfg": {"recall": round(recall, 6), "precision": round(precision, 6)}}))
    print(f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)


if __name__ == "__main__":
    main()
