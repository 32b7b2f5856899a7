"""lm_accepted_pct: LM steps accepted (the program's `ba.lm_accepted`
counter, each solve's final `n_accepted`) over the LM steps it attempted
(`ba.lm_steps`), in %; None where the spans carry no device time."""

from portbench import spans


def read(record):
    return spans.accepted_pct(record.get("program"))
