"""Linear assignment for tracking-by-detection (port of
opencv_tpu/tbd/assignment.py).

The reference associates tracks with detections by Munkres
(trackingbydetection/src/tbd.cpp:381-905, solveAssignmentProblem with a
padded square matrix of non-assignment costs). The exact solver is host
C++ (`csrc/munkres.cpp`, a copy of the JAX package's), built at first
use and bound with ctypes.

Unlike the JAX module, which drops to a NumPy solver when the native
build fails or returns an error, the port raises: a failed build or a
nonzero return code never turns into another solver. The NumPy solver
(`_solve_numpy`) stays as the plain version the tests hold the native
one against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from opencv_tpu_torch.ops.cuda import _build


def _solve_native(cost: np.ndarray) -> np.ndarray:
    """assignment[r] of a [N, M] cost matrix with N <= M, by the native
    solver. Raises when it cannot be built or returns an error."""
    lib = _build.load("munkres")
    fn = lib.munkres_solve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
                   ctypes.POINTER(ctypes.c_int32)]
    n, m = cost.shape
    c = np.ascontiguousarray(cost, np.float64)
    out = np.full(n, -1, np.int32)
    rc = fn(c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        reason = {1: "more rows than columns", 2: "no finite assignment"}.get(rc, "unknown")
        raise RuntimeError(f"munkres_solve returned {rc} ({reason}) for a {n}x{m} cost matrix")
    return out


def _solve_numpy(cost: np.ndarray) -> np.ndarray:
    """The same shortest-augmenting-path algorithm in NumPy (the plain
    version the tests compare the native solver with)."""
    n, m = cost.shape
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    match_col = np.full(m + 1, -1, np.int64)
    way = np.zeros(m + 1, np.int64)
    for r in range(n):
        j0 = m
        match_col[j0] = r
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            r0 = match_col[j0]
            cur = cost[r0, :m] - u[r0] - v[:m]
            upd = (~used[:m]) & (cur < minv[:m])
            minv[:m][upd] = cur[upd]
            way[:m][upd] = j0
            free = ~used[:m]
            if not free.any():
                break
            j1 = np.flatnonzero(free)[np.argmin(minv[:m][free])]
            delta = minv[j1]
            for j in range(m + 1):
                if used[j]:
                    if match_col[j] >= 0:
                        u[match_col[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if match_col[j0] == -1:
                break
        while j0 != m:
            j1 = way[j0]
            match_col[j0] = match_col[j1]
            j0 = j1
    out = np.full(n, -1, np.int32)
    for j in range(m):
        if match_col[j] >= 0:
            out[match_col[j]] = j
    return out


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of rows to columns. cost [N, M] (finite).
    Returns assignment[r] = column index (all rows assigned when N <= M;
    transposed internally when N > M, leaving extra rows at -1)."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.full(n, -1, np.int32)
    if n > m:
        col_for_row = np.full(n, -1, np.int32)
        for c, r in enumerate(linear_assignment(cost.T)):
            if r >= 0:
                col_for_row[r] = c
        return col_for_row
    return _solve_native(cost)


def assign_with_unassigned_cost(
    cost: np.ndarray, cost_unassigned: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tracker's association step (tbd.cpp solveAssignmentProblem):
    any row or column may stay unassigned at `cost_unassigned` each.

    Returns (row_to_col [N] with -1, unassigned_rows idx, unassigned_cols
    idx)."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.full(n, -1, np.int32), np.arange(n), np.arange(m)
    # square padding [n+m, n+m]: the top-right and bottom-left diagonals
    # carry the non-assignment cost, the rest of those blocks 1e9, the
    # bottom-right block zeros
    big = 1e9
    padded = np.zeros((n + m, n + m))
    padded[:n, :m] = cost
    padded[:n, m:] = big
    padded[n:, :m] = big
    padded[:n, m:][np.arange(n), np.arange(n)] = cost_unassigned
    padded[n:, :m][np.arange(m), np.arange(m)] = cost_unassigned
    res = linear_assignment(padded)
    row_to_col = np.where(res[:n] < m, res[:n], -1).astype(np.int32)
    un_rows = np.flatnonzero(row_to_col < 0)
    un_cols = np.setdiff1d(np.arange(m), row_to_col[row_to_col >= 0]).astype(np.int64)
    return row_to_col, un_rows, un_cols
