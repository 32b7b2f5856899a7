"""device_idle_pct: the share of the profiled window (whole solves) in
which no kernel, copy or memset ran on the card, in %."""


def read(record):
    t = record.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
