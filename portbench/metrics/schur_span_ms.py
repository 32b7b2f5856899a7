"""schur_span_ms: device ms of the program's `ba.schur` spans (the Schur
solve of each LM step) over the LM steps it attempted (`ba.lm_steps`),
from the recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.schur")
