"""normal_eq_span_ms: device ms of the program's `ba.normal_eq` spans (the
normal equations' build in each LM step) over the LM steps it attempted
(`ba.lm_steps`), from the recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.normal_eq")
