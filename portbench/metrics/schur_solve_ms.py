"""schur_solve_ms: device ms of one Schur solve (`schur_cg_solve`) at the
start problem's normal equations and lambda0, median of CUDA-event spans."""


def read(record):
    return record.get("spans", {}).get("schur_cg_solve")
