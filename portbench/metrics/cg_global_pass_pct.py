"""cg_global_pass_pct: the share of K6's passes that kept the camera sums
by global atomics (the program's `ba.cg.pass.global` counter over all its
`ba.cg.pass.*` counters), in %: the slow route, which maps whose x and h
do not fit in shared memory take. None without a record or passes."""

PREFIX = "ba.cg.pass."


def read(record):
    program = record.get("program")
    if not program:
        return None
    passes = {k: v for k, v in program["counters"].items() if k.startswith(PREFIX)}
    total = sum(passes.values())
    return 100.0 * passes.get(PREFIX + "global", 0) / total if total else None
