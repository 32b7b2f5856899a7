"""cg_wtx_span_ms: device ms of the program's `ba.cg.wtx` spans (the CG's
W^T x product: gather, per-observation einsum over A, index_add_; once per
CG iteration and in the back-substitution) over the LM steps it attempted
(`ba.lm_steps`), from the recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.cg.wtx")
