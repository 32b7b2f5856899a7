"""cg_smv_span_ms: device ms of the program's `ba.cg.smv` spans (each CG
iteration's Schur-complement product S p: on the card K6's point pass and
its camera reduce; 60 a step) over the LM steps it attempted
(`ba.lm_steps`), from the recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.cg.smv")
