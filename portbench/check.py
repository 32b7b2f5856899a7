"""The comparison that decides `correct`: the program's solves against
the plain reference's solve of the same generated problem.

Two numbers, each the worst over the sampled solves:

- `cost_gap`: |cost returned - reference cost| / reference cost;
- `residual_gap`: the largest gap, over every observation and both image
  coordinates, between the reprojection residual of the program's solved
  parameters (its cameras and points by default) and that of the
  reference's, both evaluated by the reference
  in float64 (normalized image units). Residuals do not see the weakly
  determined directions of a long loop of cameras, which either solution
  may take; they see every point and camera that an observation fixes.

Each has its limit in the traffic file; a limit lies between the largest
reading of sound runs of the program and the smallest of the control (the
reference computed with TF32 products), as PERF.md records.
"""

from __future__ import annotations

import math

import torch

# The fields a solve estimates where a configuration names no "solved".
SOLVED = ("cam_rvec", "cam_tvec", "points")


def _f64(p: dict) -> dict:
    return {k: (v.double() if v.is_floating_point() else v) for k, v in p.items()}


def compare(inputs: dict, samples: list, ref_out: tuple, ref, solved=SOLVED) -> dict:
    """{name: worst reading} of `samples` (each the `solved` fields of a
    solve, then its cost) against the reference's output (the same
    fields, then the cost). Every other field is the input's."""
    ar = ref.Arith()
    r_ref = ref.residuals(_f64(dict(inputs, **dict(zip(solved, ref_out[:-1])))), ar)
    c_ref = float(ref_out[-1])
    cost_gap = residual_gap = 0.0
    for *fields, c in samples:
        r = ref.residuals(_f64(dict(inputs, **dict(zip(solved, fields)))), ar)
        cost_gap = max(cost_gap, abs(float(c) - c_ref) / c_ref)
        residual_gap = max(residual_gap, float((r - r_ref).abs().max()))
        if not (math.isfinite(float(c)) and bool(torch.isfinite(r).all())):
            cost_gap = residual_gap = math.inf
    return {"cost_gap": cost_gap, "residual_gap": residual_gap}


def judge(readings: dict, limits: dict) -> tuple:
    """(all within their limits, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    return all(v <= limits[k] for k, v in readings.items()), shown
