"""The normal equations of bundle adjustment in one pass over the
observations: CUDA kernel `csrc/normal_eq.cu` (K7).

Replaces no Pallas kernel: the JAX package's `normal_equations`
(opencv_tpu/optim/ba.py) forms each observation's residual and Jacobians
with XLA ops, their products by einsum and the block sums by segment-sums.
The plain version is that code, kept in optim/ba.py
(`normal_equations_plain`: `_blocks`, five einsums, four `index_add_`s),
which runs it on CPU tensors. This module takes CUDA tensors only, or it
raises: optim/ba.py runs `prepare`, `fill_table`, `launch` and `finish`,
one K7 pass a call.

`fill_table` writes each camera's row (one thread a camera): R, t,
dR/drvec by the closed form of geometry/rotation.py's guarded Rodrigues
formula and its derivative, and for BAL's 9-wide cameras f, k1, k2;
`camera_table` is its plain version from `rodrigues` and
`rodrigues_jacobian`. The pass reads each observation's camera and point
indices, uv and mask, gathers its camera's row and its point, forms r,
Jc and Jp in registers with `_blocks`' mathematics, writes A = Jc^T Jp
[O,D,3] in observation order and sums U, bc by camera and V, bp by point,
all in f32. Routes (`plan`, by the camera count, the width and the
card's shared memory):

- "smem": each block keeps U's upper triangle and bc of its cameras in
  shared memory; where one block cannot hold them all, the cameras are
  split into at most MAX_RANGES ranges with blocks of their own; a
  second launch sums the blocks' partials in block order;
- "global": the camera sums by global atomics (larger maps);
- "ordered" (under deterministic algorithms): each observation's terms
  written out and summed camera by camera and point by point in
  observation order, after a stable sort: the same bits run after run.

Point sums in the first two: each warp's runs of equal points summed, then
atomics. Any observation order works; point-major order is the fast one.

Counts: `launch_counts["normal_eq_<route>"]` and the recorder's counter
`ba.neq.pass.<route>`, one per pass.

Bound and design: see the note at the top of csrc/normal_eq.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from opencv_tpu_torch.ops import cuda as _cuda
from opencv_tpu_torch.ops.cuda import _build
from opencv_tpu_torch.utils import profiler

ROUTES = {"smem": 0, "global": 1, "ordered": 2}
MAX_RANGES = 4  # camera ranges of the shared-memory route; beyond them, global atomics


def terms(width: int) -> int:
    """Camera terms a pass sums: U's upper triangle and bc."""
    return width * (width + 1) // 2 + width


def table_width(width: int) -> int:
    """Floats in a camera's row of the table: R 9, t 3, dR/drvec 27 and,
    at width 9, f, k1, k2; padded to whole 16-byte units."""
    if width not in (6, 9):
        raise ValueError(f"normal_eq: no kernel for cameras of width {width} (6 or 9)")
    return 40 if width == 6 else 44


def camera_table(R: torch.Tensor, dR: torch.Tensor, t: torch.Tensor, intr: torch.Tensor | None = None) -> torch.Tensor:
    """The pass's camera rows [C, table_width], the plain version of
    `fill_table`: R [C,3,3], t [C,3], dR [C,3,3,3] (dR_ij/drvec_k at
    [c,i,j,k]), intrinsics [C,3] or None, zeros to the end."""
    C = R.shape[0]
    parts = [R.reshape(C, 9), t, dR.reshape(C, 27)] + ([] if intr is None else [intr])
    width = 6 if intr is None else 6 + intr.shape[-1]
    used = 39 + (0 if intr is None else intr.shape[-1])
    parts.append(torch.zeros((C, table_width(width) - used), dtype=R.dtype, device=R.device))
    return torch.cat(parts, 1)


def smem_bytes(n_cams: int, width: int, ranges: int = 1) -> int:
    """Shared memory of the "smem" route's block over one of `ranges`
    ranges of n_cams cameras (csrc/normal_eq.cu `smem_bytes`)."""
    return 4 * terms(width) * -(-n_cams // ranges)


def route(n_cams: int, width: int, deterministic: bool, optin: int) -> tuple[str, int]:
    """(route, camera ranges) for n_cams cameras of `width` on a card
    whose blocks may opt into `optin` bytes of shared memory."""
    if deterministic:
        return "ordered", 1
    for ranges in range(1, MAX_RANGES + 1):
        if smem_bytes(n_cams, width, ranges) <= optin:
            return "smem", ranges
    return "global", 1


def _lib():
    return typed(_build.load("normal_eq"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with the argument and result types of csrc/normal_eq.cu's C
    interface set."""
    if not getattr(lib, "_typed", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.normal_eq_smem_optin.argtypes = []
        lib.normal_eq_smem_optin.restype = ci
        lib.normal_eq_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.normal_eq_smem_bytes.restype = ci
        lib.normal_eq_blocks.argtypes = [ci, ci, cl, ci, ci]
        lib.normal_eq_blocks.restype = ci
        lib.normal_eq_pass_launch.argtypes = [ci, ci] + [vp] * 11 + [cl, ci, ci, ci, ci, cf, vp]
        lib.normal_eq_pass_launch.restype = ci
        lib.normal_eq_cam_launch.argtypes = [ci, vp, ci, vp, vp, ci, vp, vp, vp]
        lib.normal_eq_cam_launch.restype = ci
        lib.normal_eq_point_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp]
        lib.normal_eq_point_launch.restype = ci
        lib.normal_eq_table_launch.argtypes = [ci, vp, vp, vp, ci, vp, vp]
        lib.normal_eq_table_launch.restype = ci
        lib._typed = True
    return lib


def plan(n_cams: int, width: int, deterministic: bool) -> tuple[str, int]:
    """`route` on the current card."""
    optin = _lib().normal_eq_smem_optin()
    if optin < 0:
        raise RuntimeError("normal_eq: no CUDA device to plan for")
    return route(n_cams, width, deterministic, optin)


class Pass(NamedTuple):
    """One pass's inputs, outputs and scratch on the card: the observations
    (obs_cam, obs_pt, obs_uv, obs_valid) and points in `ins`; the camera
    table [C, table_width]; U [C,D,D], V [P,3,3], bc [C,D], bp [P,3], A
    [O,D,3]; camo (smem: the partials [Q,C,K]; global: [C,K]; ordered:
    [O,K]); pto ([O,9], ordered)."""

    route: str
    ranges: int
    blocks: int
    width: int
    ins: tuple
    huber: float | None
    table: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    bc: torch.Tensor
    bp: torch.Tensor
    A: torch.Tensor
    camo: torch.Tensor
    pto: torch.Tensor | None


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"normal_eq: the kernel takes CUDA tensors, got {name} on {t.device} (CPU tensors take "
                         "the plain version: optim/ba.py's normal_equations_plain, by _blocks, einsum and "
                         "index_add_)")
    if t.dtype != dtype:
        raise ValueError(f"normal_eq: expected {name} as {dtype}, got {t.dtype}")
    return t.contiguous()


def prepare(obs_cam: torch.Tensor, obs_pt: torch.Tensor, obs_uv: torch.Tensor, obs_valid: torch.Tensor,
            points: torch.Tensor, n_cams: int, width: int, huber_delta: float | None = None) -> Pass:
    """The plan and buffers of one pass over the observations of n_cams
    cameras of `width` (no launch but the zeroing of the atomics' sums)."""
    ins = (_check(obs_cam, "obs_cam", torch.int64), _check(obs_pt, "obs_pt", torch.int64),
           _check(obs_uv, "obs_uv", torch.float32), _check(obs_valid, "obs_valid", torch.bool),
           _check(points, "points", torch.float32))
    C, P, O = n_cams, points.shape[0], obs_cam.shape[0]
    dev = points.device
    with _cuda.on_device(dev):
        rt, ranges = plan(C, width, torch.are_deterministic_algorithms_enabled())
        blocks = _lib().normal_eq_blocks(width, ROUTES[rt], O, C, ranges) if O else 0
    if blocks < 0:
        raise RuntimeError(f"normal_eq: no launch plan for {O} observations of {C} cameras ({rt}, {ranges} ranges)")
    f32 = dict(dtype=torch.float32, device=dev)
    K = terms(width)
    pto = None
    if rt == "ordered":
        V, bp = torch.empty((P, 3, 3), **f32), torch.empty((P, 3), **f32)
        camo, pto = torch.empty((O, K), **f32), torch.empty((O, 9), **f32)
    else:
        vb = torch.zeros(12 * P, **f32)  # V and bp, summed by atomics
        V, bp = vb[: 9 * P].view(P, 3, 3), vb[9 * P:].view(P, 3)
        camo = torch.empty((blocks, C, K), **f32) if rt == "smem" else torch.zeros((C, K), **f32)
    return Pass(rt, ranges, blocks, width, ins, huber_delta, torch.empty((C, table_width(width)), **f32),
                torch.empty((C, width, width), **f32), V, torch.empty((C, width), **f32), bp,
                torch.empty((O, width, 3), **f32), camo, pto)


def _stream(ps: Pass) -> int:
    return torch.cuda.current_stream(ps.table.device).cuda_stream


def fill_table(ps: Pass, rvec: torch.Tensor, tvec: torch.Tensor, intr: torch.Tensor | None = None) -> torch.Tensor:
    """The pass's camera table from rvec, tvec [C,3] (and intrinsics [C,3]
    at width 9) by the kernel's closed form of `camera_table(rodrigues,
    rodrigues_jacobian, ...)`; returns it."""
    rvec, tvec = _check(rvec, "cam_rvec", torch.float32), _check(tvec, "cam_tvec", torch.float32)
    if (intr is None) != (ps.width == 6):
        raise ValueError(f"normal_eq: cameras of width {ps.width} take {'no ' if ps.width == 6 else ''}intrinsics")
    intr = None if intr is None else _check(intr, "cam_intr", torch.float32)
    lib = _lib()
    with _cuda.on_device(ps.table.device):
        rc = lib.normal_eq_table_launch(ps.width, rvec.data_ptr(), tvec.data_ptr(),
                                        None if intr is None else intr.data_ptr(), ps.table.shape[0],
                                        ps.table.data_ptr(), _stream(ps))
    _build.check(lib, "normal_eq", rc)
    return ps.table


def launch(ps: Pass) -> None:
    """The pass alone (counted): A, and the sums into the route's buffers."""
    cam, pt, uv, valid, points = ps.ins
    O = cam.shape[0]
    if O == 0:
        return
    lib = _lib()
    with _cuda.on_device(ps.table.device):
        rc = lib.normal_eq_pass_launch(
            ps.width, ROUTES[ps.route], cam.data_ptr(), pt.data_ptr(), uv.data_ptr(), valid.data_ptr(),
            ps.table.data_ptr(), points.data_ptr(), ps.A.data_ptr(), ps.V.data_ptr(), ps.bp.data_ptr(),
            ps.camo.data_ptr(), None if ps.pto is None else ps.pto.data_ptr(), O, ps.table.shape[0], ps.ranges,
            ps.blocks, int(ps.huber is not None), 0.0 if ps.huber is None else float(ps.huber), _stream(ps))
    _build.check(lib, "normal_eq", rc)
    _cuda.launch_counts[f"normal_eq_{ps.route}"] += 1
    profiler.count(f"ba.neq.pass.{ps.route}")


def finish(ps: Pass) -> tuple[torch.Tensor, ...]:
    """U and bc from the pass's camera sums (and, ordered, V and bp from
    its point terms): (U, V, bc, bp, A)."""
    cam, pt, _, _, points = ps.ins
    C, P, O = ps.table.shape[0], points.shape[0], cam.shape[0]
    if O == 0:
        for t in (ps.U, ps.V, ps.bc, ps.bp):
            t.zero_()
        return ps.U, ps.V, ps.bc, ps.bp, ps.A
    lib = _lib()
    with _cuda.on_device(ps.table.device):
        if ps.route == "ordered":
            (cidx, coff), (pidx, poff) = (_sorted(x, n) for x, n in ((cam, C), (pt, P)))
            rc = lib.normal_eq_cam_launch(ps.width, ps.camo.data_ptr(), 0, cidx.data_ptr(), coff.data_ptr(), C,
                                          ps.U.data_ptr(), ps.bc.data_ptr(), _stream(ps))
            _build.check(lib, "normal_eq", rc)
            rc = lib.normal_eq_point_launch(ps.pto.data_ptr(), pidx.data_ptr(), poff.data_ptr(), P,
                                            ps.V.data_ptr(), ps.bp.data_ptr(), _stream(ps))
        else:
            nparts = ps.camo.shape[0] if ps.camo.dim() == 3 else 1
            rc = lib.normal_eq_cam_launch(ps.width, ps.camo.data_ptr(), nparts, None, None, C, ps.U.data_ptr(),
                                          ps.bc.data_ptr(), _stream(ps))
    _build.check(lib, "normal_eq", rc)
    return ps.U, ps.V, ps.bc, ps.bp, ps.A


def _sorted(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A stable sort of the observations by idx, and each entry's offsets in it [n+1]."""
    keys, order = torch.sort(idx, stable=True)
    return order, torch.searchsorted(keys, torch.arange(n + 1, device=idx.device, dtype=keys.dtype))
