"""LK window sampler: CUDA kernel `csrc/lk_sample.cu` and its plain version.

Replaces the Pallas kernels of opencv_tpu/ops/pallas/lk_sample.py:
K4 `_tmpl_kernel` (`sample_channels_pallas`, with the wrappers
`sample_templates_pallas` and `sample_single_pallas`) and K5
`_sample_kernel` (`sample_windows_pallas`), the edge-clamp mode of the
same kernel.

K4: bilinear win x win windows of C channels [H, W] around N points
(x, y), [C, N, win, win] f32. A tap counts only if its source pixel lies
in [0, H) x [0, W); a wholly outside or non-finite point gives a zero
window. K5: one channel, rows and columns clamped to the image edge
(exact against the XLA sampler for points half a window inside).

Design: a block takes P consecutive points (1024 outputs or one point)
and all C channels, stages each window's (win+1)^2 taps in shared
memory, and its threads write the points' windows as one contiguous run
of `out` per channel. Per point it first builds the clamped tap indices,
the row and column validity codes, and 16 masked weight quadruples, so
an output costs one weight load, four tap loads and seven f32 operations
per channel. Windows 21 and 48 are compiled in for 1 to 4 channels; a
generic instantiation serves the rest, and reads its taps from global
memory where they do not fit in shared memory (on an H100, one channel
above win 238, four above win 119).

Bound: bytes, almost all written: the three level-0 sites of a track at
N = 2000 write 32 MB, 0.0115 ms at 3.35 TB/s on an H100 SXM. The first
design (one block per point and channel, four global tap reads, four
masked weights and two runtime divisions per output) took 0.0601 ms
there, slower than F.grid_sample's 0.0443 ms: the sampler's time follows
its instructions per output, not its bytes. This design takes 0.0314 ms (NVIDIA H100 80GB
HBM3, 700.00 W, chip_smoke.py). Details in the note at the top of
csrc/lk_sample.cu; per-site times in PERF.md.
"""

from __future__ import annotations

import ctypes

import torch

from opencv_tpu_torch.ops import cuda as _counts
from opencv_tpu_torch.ops.cuda import _build

MAX_CHANNELS = 4
FAR = 1e6  # non-finite and far-away origins are pinned to -FAR / +FAR


# ------------------------------------------------------------ plain version


def _origin(pts: torch.Tensor, win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Window origins: (integer part [N, 2] i64, fraction [N, 2] f32)."""
    start = pts.to(torch.float32) - float(win // 2)
    start = torch.where(torch.isfinite(start), start, torch.full_like(start, -FAR))
    start = start.clamp(-FAR, FAR)
    i0 = torch.floor(start)
    return i0.to(torch.int64), start - i0


def _taps(chans: torch.Tensor, pts: torch.Tensor, win: int):
    """Origins, fractions, tap coordinates and the four taps [C, N, win, win]
    read at edge-clamped indices."""
    c, h, w = chans.shape
    i0, frac = _origin(pts, win)
    ar = torch.arange(win, device=pts.device)
    rows = i0[:, 1, None] + ar  # [N, win]
    cols = i0[:, 0, None] + ar
    flat = chans.reshape(c, h * w)

    def tap(dy: int, dx: int) -> torch.Tensor:
        ry = (rows + dy).clamp(0, h - 1)
        cx = (cols + dx).clamp(0, w - 1)
        return flat[:, ry[:, :, None] * w + cx[:, None, :]]

    fy = frac[:, 1, None, None]
    fx = frac[:, 0, None, None]
    return rows, cols, fy, fx, (tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1))


def sample_channels_plain(chans: torch.Tensor, pts: torch.Tensor, win: int) -> torch.Tensor:
    """K4's plain version: chans [C, H, W], pts [N, 2] (x, y) ->
    [C, N, win, win], in the kernel's order of operations."""
    h, w = chans.shape[-2:]
    rows, cols, fy, fx, (t00, t01, t10, t11) = _taps(chans.to(torch.float32), pts, win)
    vr0 = ((rows >= 0) & (rows <= h - 1))[:, :, None]
    vr1 = ((rows + 1 >= 0) & (rows + 1 <= h - 1))[:, :, None]
    vc0 = ((cols >= 0) & (cols <= w - 1))[:, None, :]
    vc1 = ((cols + 1 >= 0) & (cols + 1 <= w - 1))[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=pts.device)
    m00 = torch.where(vr0 & vc0, (1.0 - fy) * (1.0 - fx), zero)
    m01 = torch.where(vr0 & vc1, (1.0 - fy) * fx, zero)
    m10 = torch.where(vr1 & vc0, fy * (1.0 - fx), zero)
    m11 = torch.where(vr1 & vc1, fy * fx, zero)
    return t00 * m00 + t01 * m01 + t10 * m10 + t11 * m11


def sample_windows_plain(img: torch.Tensor, pts: torch.Tensor, win: int) -> torch.Tensor:
    """K5's plain version: img [H, W] -> [N, win, win], edge-clamped taps,
    rows interpolated first."""
    _, _, fy, fx, (t00, t01, t10, t11) = _taps(img.to(torch.float32)[None], pts, win)
    gy, gx = 1.0 - fy, 1.0 - fx
    a = gy * t00 + fy * t10
    b = gy * t01 + fy * t11
    return (gx * a + fx * b)[0]


# ------------------------------------------------------------ CUDA kernel


def _lib():
    lib = _build.load("lk_sample")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lk_sample_launch.argtypes = [vp, vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.lk_sample_launch.restype = ci
        lib._typed = True
    return lib


def _check(chans, pts: torch.Tensor, win: int) -> None:
    if not 1 <= len(chans) <= MAX_CHANNELS:
        raise ValueError(f"lk_sample: 1 to {MAX_CHANNELS} channels, got {len(chans)}")
    shape = chans[0].shape
    if len(shape) != 2 or any(c.shape != shape for c in chans):
        raise ValueError(f"lk_sample: channels must share one [H, W] shape, got "
                         f"{[tuple(c.shape) for c in chans]}")
    if pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"lk_sample: points must be [N, 2], got {tuple(pts.shape)}")
    if win < 1:
        raise ValueError(f"lk_sample: window {win}")
    devices = {c.device for c in chans} | {pts.device}
    if len(devices) != 1:
        raise ValueError(f"lk_sample: tensors on several devices: {devices}")


def _launch(chans, pts: torch.Tensor, win: int, clamp: bool) -> torch.Tensor:
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"lk_sample kernel: expected CUDA tensors, got {dev}")
    xs = [c.to(torch.float32).contiguous() for c in chans]
    p = pts.to(torch.float32).contiguous()
    h, w = xs[0].shape
    n = p.shape[0]
    out = torch.empty((len(xs), n, win, win), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in xs] + [None] * (MAX_CHANNELS - len(xs))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.lk_sample_launch(
            *ptrs, len(xs), p.data_ptr(), out.data_ptr(), n, h, w, win, int(clamp),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, "lk_sample", rc)
    return out


def sample_channels(chans, pts: torch.Tensor, win: int = 21) -> torch.Tensor:
    """K4: windows of every channel of `chans` (a [C, H, W] tensor or a
    sequence of C [H, W] tensors, C <= 4) at pts [N, 2] ->
    [C, N, win, win] f32. CPU tensors take the plain version."""
    chans = list(chans)
    _check(chans, pts, win)
    if pts.device.type == "cpu":
        return sample_channels_plain(torch.stack(chans), pts, win)
    out = _launch(chans, pts, win, clamp=False)
    _counts.launch_counts["lk_sample"] += 1
    return out


def sample_templates(img, dx, dy, pts: torch.Tensor, win: int = 21):
    """The (image, dx, dy) template triple of one LK level: one K4 call."""
    out = sample_channels((img, dx, dy), pts, win)
    return out[0], out[1], out[2]


def sample_single(img: torch.Tensor, pts: torch.Tensor, win: int = 21) -> torch.Tensor:
    """Single-channel K4 windows [N, win, win] (the polish sample, and the
    patch extraction at integer points, where every fraction is 0)."""
    return sample_channels((img,), pts, win)[0]


def sample_windows(img: torch.Tensor, pts: torch.Tensor, win: int = 21) -> torch.Tensor:
    """K5: edge-clamped windows of img [H, W] at pts [N, 2] -> [N, win, win]."""
    _check([img], pts, win)
    if pts.device.type == "cpu":
        return sample_windows_plain(img, pts, win)
    out = _launch([img], pts, win, clamp=True)[0]
    _counts.launch_counts["lk_sample_clamp"] += 1
    return out
