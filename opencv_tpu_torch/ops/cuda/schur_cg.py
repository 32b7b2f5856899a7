"""The Schur-CG products of bundle adjustment: CUDA kernel `csrc/schur_cg.cu`
and its plain version.

Replaces no Pallas kernel: the JAX package's `schur_cg_solve` leaves its
two per-observation products (W^T x, then W z after V^-1) to XLA's
gathers and segment-sums. The plain version here is that code, einsum and
`index_add_` per observation (`wt_x_plain`, `w_z_plain`); optim/ba.py runs
it on CPU tensors. `SchurProducts` takes CUDA tensors only: one
point-major pass over A a product, or it raises.

The point-major layout (`point_layout`, once per solve, on the device and
without a host synchronization): a stable sort of the observations by
point, A and the (camera, point) pairs gathered in that order, the point
offsets, chunks of whole points (chunk k: the points whose observations
begin in [k STRIDE, (k+1) STRIDE)), which the kernel's blocks share out
in order, and each chunk's observations in camera order. Any observation
order works.

The entries: `smv` (S x fused: W^T x, V^-1 and W z in one pass, then one
camera reduce that finishes mask * (Ud x - h) and, for the CG, the dot
partials of p.Sp), `wt_x` (W^T x) and `w_vinv` (W V^-1 g, the camera sums
unfinished), `finish` (a camera sum finished as S x or as the right-hand
side, no pass), `back` (the back-substitution), and `apply_vinv` (V^-1 r,
the back-substitution after an all-reduce; a BACK pass without x, which
streams A unread, once a step). The
CG's vector work between two products is one one-block launch
(`cg_start`, `cg_step`). The halves and the fused pass form each point's
z by one code path and sum in the same fixed orders, so `smv` gives the
bits of `finish(w_vinv(wt_x(x)))` and `back` those of `apply_vinv(bp -
wt_x(dc))` wherever the accumulator is not "global".
h goes to shared memory where x and h of every camera fit beside the
ring of stages ("smem": a fixed summation order, so the same bits run
after run), else to global atomics with x read through L1 ("global"),
or, under deterministic algorithms, per observation and then camera by
camera ("ordered").

Counts: `launch_counts["schur_cg_<mode>"]` per pass launched and
`launch_counts["schur_cg_update"]` per CG update or start, and the
recorder's counters `ba.cg.pass.smem`, `ba.cg.pass.global`,
`ba.cg.pass.ordered` per pass.

Bound and design: see the note at the top of csrc/schur_cg.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from opencv_tpu_torch.ops import cuda as _counts
from opencv_tpu_torch.ops.cuda import _build
from opencv_tpu_torch.utils import profiler

STRIDE = 416  # observations a chunk starts within; a stage holds 512
MODES = {"full": 0, "hz": 1, "back": 2, "g": 3}
ACCUMULATORS = {"smem": 0, "global": 1, "ordered": 2}


# ------------------------------------------------------------ plain version


def wt_x_plain(A: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor, x: torch.Tensor,
               n_pts: int) -> torch.Tensor:
    """W^T x [P,3] for x [C,6]: per observation A^T x_c, summed by point."""
    tx = torch.einsum("oij,oi->oj", A, x[obs_cam])
    return torch.zeros((n_pts, 3), dtype=A.dtype, device=A.device).index_add_(0, obs_pt, tx)


def w_z_plain(A: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor, z: torch.Tensor,
              n_cams: int) -> torch.Tensor:
    """W z [C,6] for z [P,3]: per observation A z_p, summed by camera."""
    wz = torch.einsum("oij,oj->oi", A, z[obs_pt])
    return torch.zeros((n_cams, 6), dtype=A.dtype, device=A.device).index_add_(0, obs_cam, wz)


# ------------------------------------------------------------ point-major layout


class PointLayout(NamedTuple):
    """perm [O] i64 (point-major position -> observation); idx [O+2,2] i32
    (camera, point) point-major, two rows of padding; off [P+1] i32 (a
    view of P+5 entries); chunk_obs, chunk_pt [K+1] i32; with
    `camera_runs`, cs [O] i16 (a view of O+8 entries): at each chunk's
    positions, its observations in camera order (stable; the chunk-local
    index in bits 0-14, bit 15 set on the first of each camera), else
    None; with `ordered`, cidx [O] i32 (the point-major
    positions camera by camera, point-major within a camera) and coff
    [C+1] i32, else None."""

    perm: torch.Tensor
    idx: torch.Tensor
    off: torch.Tensor
    chunk_obs: torch.Tensor
    chunk_pt: torch.Tensor
    cs: torch.Tensor | None
    cidx: torch.Tensor | None
    coff: torch.Tensor | None


def point_layout(obs_cam: torch.Tensor, obs_pt: torch.Tensor, n_cams: int, n_pts: int,
                 camera_runs: bool = False, ordered: bool = False) -> PointLayout:
    """The point-major layout of the observations, on their device, with
    no host synchronization."""
    dev = obs_pt.device
    n_obs = obs_pt.shape[0]
    if n_obs >= 2 ** 31 - 2 * STRIDE:
        raise ValueError(f"schur_cg: {n_obs} observations, at most 2^31 - {2 * STRIDE}")
    sorted_pt, perm = torch.sort(obs_pt, stable=True)
    idx = torch.zeros((n_obs + 2, 2), dtype=torch.int32, device=dev)
    idx[:n_obs, 0] = obs_cam[perm]
    idx[:n_obs, 1] = sorted_pt
    # four entries of padding (equal to n_obs) past off[P]: the kernel copies offsets 4 points at a time
    off = torch.searchsorted(sorted_pt, torch.arange(n_pts + 5, device=dev, dtype=sorted_pt.dtype),
                             out_int32=True)[: n_pts + 1]
    n_chunks = max(1, -(-n_obs // STRIDE))
    starts = torch.arange(n_chunks, device=dev, dtype=torch.int32) * STRIDE
    chunk_pt = torch.full((n_chunks + 1,), n_pts, dtype=torch.int32, device=dev)
    chunk_pt[:n_chunks] = torch.searchsorted(off[:n_pts], starts, out_int32=True)
    chunk_obs = off[chunk_pt.long()]
    cs = cidx = coff = None
    if camera_runs:
        pos = torch.arange(n_obs, device=dev, dtype=torch.int32)
        chunk = torch.searchsorted(chunk_obs, pos, right=True) - 1
        keys, order = torch.sort(chunk.long() * n_cams + idx[:n_obs, 0], stable=True)
        first = torch.ones(n_obs, dtype=torch.bool, device=dev)
        first[1:] = keys[1:] != keys[:-1]
        # eight entries of padding: the kernel copies 8 entries at a time
        cs = torch.zeros(n_obs + 8, dtype=torch.int16, device=dev)[:n_obs]
        cs[:] = order - chunk_obs[chunk[order]] - 32768 * first
    if ordered:
        cams, cidx = torch.sort(idx[:n_obs, 0], stable=True)
        cidx = cidx.to(torch.int32)
        coff = torch.searchsorted(cams, torch.arange(n_cams + 1, device=dev, dtype=cams.dtype),
                                  out_int32=True)
    return PointLayout(perm, idx, off, chunk_obs, chunk_pt, cs, cidx, coff)


# ------------------------------------------------------------ CUDA kernel


def _lib():
    return typed(_build.load("schur_cg"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with the argument and result types of csrc/schur_cg.cu's C
    interface set."""
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.schur_cg_smem_optin.argtypes = []
        lib.schur_cg_smem_optin.restype = ci
        lib.schur_cg_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.schur_cg_smem_bytes.restype = ci
        lib.schur_cg_pass_launch.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp,
                                             ci, ci, ci, ci, vp]
        lib.schur_cg_pass_launch.restype = ci
        lib.schur_cg_reduce_launch.argtypes = [ci, vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp]
        lib.schur_cg_reduce_launch.restype = ci
        lib.schur_cg_reduce_blocks.argtypes = [ci]
        lib.schur_cg_reduce_blocks.restype = ci
        lib.schur_cg_update_launch.argtypes = [ci, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.schur_cg_update_launch.restype = ci
        lib._typed = True
    return lib


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def plan(n_cams: int, deterministic: bool) -> tuple[str, int, bool]:
    """(accumulator, ring stages, x in shared memory) for a map of n_cams
    cameras on the current card: h and x in shared memory beside three
    stages, or two (a fixed summation order); else h by global atomics
    and x through L1, or, under deterministic algorithms, h written per
    observation and x in shared memory where it fits."""
    lib = _lib()
    optin = lib.schur_cg_smem_optin()
    if optin < 0:
        raise RuntimeError("schur_cg: no CUDA device to plan for")

    def fits(stages, x_smem, h_smem):
        return lib.schur_cg_smem_bytes(stages, n_cams, int(x_smem), int(h_smem)) <= optin

    for stages in (3, 2):
        if fits(stages, True, True):
            return "smem", stages, True
    if deterministic:
        return "ordered", 3, fits(3, True, False)
    return "global", 3, False


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    if t is None:
        return None
    if t.dtype != torch.float32:
        raise ValueError(f"schur_cg: expected float32, got {t.dtype}")
    return t.contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


class CGState(NamedTuple):
    """The CG's vectors on the card: x, r, z, p, Sp [C,6], rz [1], the
    reduce's dot partials of p.Sp, Minv [C,6,6] (contiguous)."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    sp: torch.Tensor
    rz: torch.Tensor
    dots: torch.Tensor
    minv: torch.Tensor


class SchurProducts:
    """The CG's products over A [O,6,3] on the card for one solve, V^-1
    [P,3,3] and the camera mask [C,1] (1 free, 0 fixed) fixed, over a
    point-major layout built here. CUDA tensors only."""

    def __init__(self, A: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor,
                 vinv: torch.Tensor, mask: torch.Tensor, n_cams: int, n_pts: int):
        if A.device.type != "cuda":
            raise ValueError(f"schur_cg: the kernel takes CUDA tensors, got {A.device} "
                             "(CPU tensors take wt_x_plain and w_z_plain)")
        self.n_cams, self.n_pts = n_cams, n_pts
        self.device = A.device
        with torch.cuda.device(A.device):
            self.acc, self.stages, self.x_smem = plan(n_cams, torch.are_deterministic_algorithms_enabled())
        lay = point_layout(obs_cam, obs_pt, n_cams, n_pts, camera_runs=self.acc == "smem",
                           ordered=self.acc == "ordered")
        self.layout = lay
        n_obs = obs_pt.shape[0]
        self.A_pm = torch.empty((n_obs + 2, 6, 3), dtype=torch.float32, device=A.device)
        torch.index_select(_f32(A), 0, lay.perm, out=self.A_pm[:n_obs])
        self.A_pm[n_obs:].zero_()
        # V^-1 [P+4, 9]: the kernel copies V^-1 4 points at a time
        self.vinv_c = torch.zeros((n_pts + 4, 9), dtype=torch.float32, device=A.device)
        self.vinv_c[:n_pts] = _f32(vinv).reshape(n_pts, 9)
        self.mask_c = _f32(mask.reshape(-1))
        self.blocks = min(_sm_count(A.device), lay.chunk_obs.shape[0] - 1)
        self.stream = torch.cuda.current_stream(A.device).cuda_stream
        self._h = None  # smv's h buffer, reused from call to call
        self._lay_ptrs = (self.A_pm.data_ptr(), lay.idx.data_ptr(), _ptr(lay.cs), lay.off.data_ptr(),
                          lay.chunk_obs.data_ptr(), lay.chunk_pt.data_ptr(), lay.chunk_obs.shape[0] - 1)

    # -------------------------------------------------------- kernel launches

    def launch(self, mode: str, x=None, mask=None, pin=None, pout=None, hout=None) -> None:
        """One pass of the kernel in `mode` (MODES), its arrays as
        csrc/schur_cg.cu's Args has them; counted."""
        lib = _lib()
        with torch.cuda.device(self.device):
            rc = lib.schur_cg_pass_launch(
                MODES[mode], ACCUMULATORS[self.acc], *self._lay_ptrs, _ptr(x), _ptr(mask),
                self.vinv_c.data_ptr(), _ptr(pin), _ptr(pout), _ptr(hout), self.n_cams, self.blocks,
                self.stages, int(self.x_smem), self.stream)
        _build.check(lib, "schur_cg", rc)
        _counts.launch_counts[f"schur_cg_{mode}"] += 1
        profiler.count(f"ba.cg.pass.{self.acc}")

    def h_buffer(self) -> torch.Tensor:
        """Where a pass puts h: block partials [blocks,C,6] (smem), h [C,6]
        zeroed (global), or per observation [O,6] (ordered)."""
        C = self.n_cams
        if self.acc == "smem":
            return torch.empty((self.blocks, C, 6), dtype=torch.float32, device=self.device)
        if self.acc == "global":
            return torch.zeros((C, 6), dtype=torch.float32, device=self.device)
        return torch.empty((self.A_pm.shape[0] - 2, 6), dtype=torch.float32, device=self.device)

    def _reduce(self, parts: torch.Tensor, ordered=False, ud=None, x=None, base=None, mask=None,
                dots=None, out=None) -> torch.Tensor:
        lay, lib = self.layout, _lib()
        if out is None:
            out = torch.empty((self.n_cams, 6), dtype=torch.float32, device=self.device)
        nparts = parts.shape[0] if parts.dim() == 3 else 1
        with torch.cuda.device(self.device):
            rc = lib.schur_cg_reduce_launch(int(ordered), parts.data_ptr(), nparts, _ptr(lay.cidx),
                                            _ptr(lay.coff), self.n_cams, _ptr(ud), _ptr(x), _ptr(base),
                                            _ptr(mask), out.data_ptr(), _ptr(dots), self.stream)
        _build.check(lib, "schur_cg", rc)
        return out

    def _sums(self, hbuf: torch.Tensor) -> torch.Tensor:
        """What the finishing reduce sums: the block partials (smem), or h
        [C,6] (global as it stands; ordered summed camera by camera)."""
        return self._reduce(hbuf, ordered=True) if self.acc == "ordered" else hbuf

    def _points(self) -> torch.Tensor:
        return torch.empty((self.n_pts, 3), dtype=torch.float32, device=self.device)

    # -------------------------------------------------------- products

    def smv(self, x: torch.Tensor, ud: torch.Tensor, cg: CGState | None = None) -> torch.Tensor:
        """S x = mask * (Ud (x mask) - W V^-1 W^T (x mask)) [C,6] by one
        fused pass; with a CG state (x its p), into its Sp, with the dot
        partials of x.Sp."""
        x = _f32(x)
        if self._h is None:
            self._h = self.h_buffer()
        if self.acc == "global":
            self._h.zero_()
        self.launch("full", x=x, mask=self.mask_c, hout=self._h)
        return self.finish(self._sums(self._h), ud=ud, x=x, cg=cg)

    def wt_x(self, x: torch.Tensor) -> torch.Tensor:
        """W^T (x mask) [P,3]."""
        g = self._points()
        self.launch("g", x=_f32(x), mask=self.mask_c, pout=g)
        return g

    def w_vinv(self, g: torch.Tensor) -> torch.Tensor:
        """h = W (V^-1 g) [C,6], unfinished."""
        hbuf = self.h_buffer()
        self.launch("hz", pin=_f32(g), hout=hbuf)
        h = self._sums(hbuf)
        return self._reduce(h) if h.dim() == 3 else h

    def finish(self, h: torch.Tensor, ud=None, x=None, base=None, cg: CGState | None = None) -> torch.Tensor:
        """From h [C,6] (or a pass's block partials): S x = mask * (Ud (x
        mask) - h) (ud and x, or a CG state whose p is x: into its Sp with
        the dot partials of x.Sp), or the right-hand side mask * (base - h)."""
        if cg is not None:
            return self._reduce(_f32(h), ud=_f32(ud), x=cg.p, mask=self.mask_c, dots=cg.dots, out=cg.sp)
        return self._reduce(_f32(h), ud=_f32(ud), x=_f32(x), base=_f32(base), mask=self.mask_c)

    def back(self, dc: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
        """V^-1 (bp - W^T (dc mask)) [P,3]."""
        dp = self._points()
        self.launch("back", x=_f32(dc), mask=self.mask_c, pin=_f32(bp), pout=dp)
        return dp

    def apply_vinv(self, r: torch.Tensor) -> torch.Tensor:
        """V^-1 r [P,3], by the back-substitution's arithmetic."""
        dp = self._points()
        self.launch("back", pin=_f32(r), pout=dp)
        return dp

    # -------------------------------------------------------- the CG's vector work

    def cg_start(self, rhs: torch.Tensor, minv: torch.Tensor) -> CGState:
        """The CG from r = rhs [C,6]: x = 0, z = mask Minv r, p = z,
        rz = r.z, in one launch."""
        C = self.n_cams
        cg = CGState(*(torch.empty((C, 6), dtype=torch.float32, device=self.device) for _ in range(5)),
                     rz=torch.empty(1, dtype=torch.float32, device=self.device),
                     dots=torch.empty(max(1, _lib().schur_cg_reduce_blocks(C)), dtype=torch.float32,
                                      device=self.device),
                     minv=_f32(minv))
        cg.r.copy_(rhs)
        self._update(0, cg)
        return cg

    def cg_step(self, cg: CGState) -> None:
        """After cg.sp = S cg.p (with its dot partials): one CG update of
        x, r, z, p and rz in one launch."""
        self._update(1, cg)

    def _update(self, step: int, cg: CGState) -> None:
        lib = _lib()
        with torch.cuda.device(self.device):
            rc = lib.schur_cg_update_launch(step, self.n_cams, cg.sp.data_ptr(), cg.dots.data_ptr(),
                                            cg.dots.shape[0], cg.minv.data_ptr(), self.mask_c.data_ptr(),
                                            cg.x.data_ptr(), cg.r.data_ptr(), cg.z.data_ptr(),
                                            cg.p.data_ptr(), cg.rz.data_ptr(), self.stream)
        _build.check(lib, "schur_cg", rc)
        _counts.launch_counts["schur_cg_update"] += 1
