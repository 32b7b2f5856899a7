"""Peaks of the cards the benchmark runs on, and the least time of the
CG solver's work, as fixed formulas of the problem's shapes.

The peak is NVIDIA's published HBM3 bandwidth of the SXM part at its
700 W limit: the CG's work is bound by memory, not by arithmetic.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_byte_s": 3.35e12},
}


def cg_bytes_per_obs(camera_params: int) -> int:
    """Bytes one CG iteration reads an observation: A ([O, camera_params,
    3] float32) once, and the observation's camera and point indices
    (int64, 16 B). 88 B for a 6-parameter camera."""
    return 12 * camera_params + 16


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}: add them to portbench/roofline.py")
    return PEAKS[kind]


def cg_least_s(cg_iters: int, n_obs: int, camera_params: int, kind: str) -> float:
    """Least time of `schur_cg_solve`: A and the index rows read once per
    CG iteration at HBM bandwidth."""
    return cg_iters * n_obs * cg_bytes_per_obs(camera_params) / peaks(kind)["hbm_byte_s"]
