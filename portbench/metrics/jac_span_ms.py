"""jac_span_ms: device ms of the program's `ba.jac` spans (each LM step's
per-observation residuals and Jacobians, `_blocks`, inside `ba.normal_eq`;
with BAL's cameras the distortion and intrinsics columns too) over the LM
steps it attempted (`ba.lm_steps`), from the recorder's CUDA events over
whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.jac")
