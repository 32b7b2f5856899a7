"""lm_update_span_ms: device ms of the program's `ba.update` spans (the
candidate's parameters and cost, the accept test, the merge and the lambda
update) over the LM steps it attempted (`ba.lm_steps`), from the
recorder's CUDA events over whole solves."""

from portbench import spans


def read(record):
    return spans.per_step_ms(record.get("program"), "ba.update")
