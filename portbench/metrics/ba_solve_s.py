"""ba_solve_s: the window's seconds over the whole solves it completed."""


def read(record):
    w = record.get("window")
    return w["seconds"] / len(w["solve_times"]) if w else None
