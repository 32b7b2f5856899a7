"""cg_wz_span_ms: device ms of the program's `ba.cg.wz` spans (the CG's W z
product: gather, per-observation einsum over A, index_add_; for the
right-hand side and once per CG iteration) over the LM steps it attempted
(`ba.lm_steps`), from the recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.cg.wz")
