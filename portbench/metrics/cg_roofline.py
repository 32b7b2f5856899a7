"""cg_roofline: the least time of `schur_cg_solve` (A, at the camera's
width, and the index rows read once per CG iteration at HBM bandwidth)
over its measured time, in %."""

from portbench import roofline


def read(record):
    ms = record.get("spans", {}).get("schur_cg_solve")
    if ms is None:
        return None
    s = record["shapes"]
    least = roofline.cg_least_s(s["cg_iters"], s["observations"], s["camera_params"], record["kind"])
    return 100.0 * least / (ms * 1e-3)
