"""kernels_per_lm_iter: kernels the card ran in the profiled window over
the LM iterations of its solves (each solve's first cost included)."""


def read(record):
    t = record.get("trace")
    if not t:
        return None
    return t["kernels"] / (record["solves_traced"] * record["shapes"]["lm_iters"])
