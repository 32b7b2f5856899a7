"""Video stabilization (port of opencv_tpu/ops/videostab.py; the reference's
videostab pipeline: global motion by RANSAC over tracked features,
Gaussian trajectory smoothing, compensating warps; Wiener deblurring,
border inpainting and wobble suppression).

Per frame pair, on the device: GFTT (200 corners, quality 0.01, min
distance 12), pyramidal LK at 3 levels (level 0 of a 480x640 frame goes
through kernel K4), and a 256-hypothesis affine RANSAC with an
inlier-weighted refit. The JAX package fits each affine with
`jnp.linalg.lstsq` (SVD, minimum norm where the rows are rank
deficient, as the refit's zeroed rows can make them); here the 3x3
normal equations are formed and pseudo-inverted in f64, which gives the
same least-squares solution and the same minimum-norm one. RANSAC draws
its subsets from a CPU generator, so a seed gives the same subsets on the
card as on the CPU; tests inject the JAX-drawn ones. Trajectory
smoothing and border inpainting are host numpy, copied from the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.config import LKConfig, RansacConfig
from opencv_tpu_torch.device import no_tf32, resolve_device
from opencv_tpu_torch.geometry import ransac as ransac_mod
from opencv_tpu_torch.ops import gftt, lk

# jnp.linalg.lstsq's default cut-off, f32 eps x the larger dimension,
# relative to A's largest singular value (squared: M = A^T A)
_F32_EPS = float(np.finfo(np.float32).eps)


def _affine_from_pairs(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor | None = None):
    """Least-squares affine [..., 2, 3] mapping p0 [..., n, 2] to p1 (rows
    weighted by w [..., n], 0 dropping a row), and ok [...] where it is
    finite. lstsq's solution (minimum norm if rank deficient) through the
    f64 normal equations."""
    a = torch.cat([p0, torch.ones_like(p0[..., :1])], -1).double()
    b = p1.double()
    if w is not None:
        a = a * w.double()[..., None]
        b = b * w.double()[..., None]
    m = a.transpose(-1, -2) @ a  # [..., 3, 3]
    rcond = _F32_EPS * max(p0.shape[-2], 3)
    sol = torch.linalg.pinv(m, rtol=rcond * rcond, hermitian=True) @ (a.transpose(-1, -2) @ b)
    sol = sol.transpose(-1, -2).to(torch.float32)
    return sol, torch.isfinite(sol).flatten(-2).all(-1)


def estimate_global_motion(frame0, frame1, gen: torch.Generator | None = None,
                           max_corners: int = 200, threshold_px: float = 2.0,
                           subsets: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """Affine [2, 3] mapping frame0 coordinates to frame1 coordinates
    (videostab's MotionEstimatorRansacL2 analog), on the device. RANSAC
    draws from `gen` unless `subsets` [256, 3] are given. Runs on the card
    unless `device="cpu"`."""
    dev = resolve_device(device)
    frame0 = torch.as_tensor(frame0, device=dev).to(torch.float32)
    frame1 = torch.as_tensor(frame1, device=dev).to(torch.float32)
    kp = gftt.good_features_to_track(frame0, max_corners, 0.01, 12.0, device=dev)
    pts = kp.xy
    new, status, _ = lk.calc_optical_flow_pyr_lk(frame0, frame1, pts, kp.valid,
                                                 LKConfig(n_levels=3), device=dev)
    valid = status & kp.valid

    def model_fn(idx):
        return _affine_from_pairs(pts[idx], new[idx])

    def error_fn(m):
        proj = torch.einsum("nk,hjk->hnj", pts, m[:, :, :2]) + m[:, None, :, 2]
        return ((proj - new) ** 2).sum(-1)

    with no_tf32():
        res = ransac_mod.ransac(gen, pts.shape[0], valid, 3, model_fn, error_fn,
                                RansacConfig(n_hypotheses=256, threshold=threshold_px ** 2),
                                subsets=subsets)
        sol, _ = _affine_from_pairs(pts, new, res.inliers.to(torch.float32))
    return sol


def smooth_trajectory(motions: np.ndarray, radius: int = 5) -> np.ndarray:
    """Gaussian-smooth a sequence of per-frame affine params [F, 2, 3]
    (GaussianMotionFilter analog)."""
    sigma = max(radius / 2.0, 1e-3)
    xs = np.arange(-radius, radius + 1)
    g = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    g /= g.sum()
    flat = motions.reshape(motions.shape[0], -1)
    padded = np.pad(flat, ((radius, radius), (0, 0)), mode="edge")
    out = np.stack(
        [np.convolve(padded[:, i], g, mode="valid") for i in range(flat.shape[1])],
        axis=1,
    )
    return out.reshape(motions.shape)


def estimate_motions(frames, seed: int = 0, device=None) -> np.ndarray:
    """Motion of every consecutive pair of frames [F, H, W]: [F, 2, 3]
    f32, the identity first, then estimate_global_motion of (t-1, t), one
    generator seeded with `seed` drawing the RANSAC subsets in pair order.
    Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    frames = [torch.as_tensor(f, device=dev).to(torch.float32) for f in frames]
    gen = torch.Generator()
    gen.manual_seed(seed)
    eye = torch.eye(2, 3, device=dev)
    motions = [eye] + [estimate_global_motion(frames[i - 1], frames[i], gen, device=dev)
                       for i in range(1, len(frames))]
    return torch.stack(motions).cpu().numpy()


def stabilize(frames, radius: int = 5, seed: int = 0, device=None) -> torch.Tensor:
    """The pipeline: the motion of every consecutive pair, the cumulative
    trajectory smoothed, each frame warped by the compensating transform.
    frames: [F, H, W] (array, tensor or list of frames). Returns the
    stabilized frames [F, H, W] on the device; runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    frames = torch.stack([torch.as_tensor(f, device=dev).to(torch.float32) for f in frames])
    f, h, w = frames.shape
    motions = estimate_motions(frames, seed, dev)
    eye = motions[0]

    def compose(a, b):
        """affine composition: (a o b)(x) = a(b(x))"""
        m = np.eye(3, dtype=np.float32)
        m[:2] = a
        n = np.eye(3, dtype=np.float32)
        n[:2] = b
        return (m @ n)[:2]

    traj = [eye]
    for i in range(1, f):
        traj.append(compose(motions[i], traj[i - 1]))
    traj = np.asarray(traj)
    smooth = smooth_trajectory(traj, radius)

    out = []
    for i in range(f):
        # warp the frame so that its trajectory follows the smoothed one:
        # correction = traj_i o smooth_i^-1 (warp_affine maps output to input)
        t3 = np.eye(3, dtype=np.float32)
        t3[:2] = traj[i]
        s3 = np.eye(3, dtype=np.float32)
        s3[:2] = smooth[i]
        corr = t3 @ np.linalg.inv(s3)
        out.append(imgproc.warp_affine(frames[i], corr[:2], h, w))
    return torch.stack(out)


def deblur_weiner_gaussian(frame, motion_px: float, angle: float = 0.0, snr: float = 40.0,
                           device=None) -> torch.Tensor:
    """Wiener deconvolution of a linear motion blur of `motion_px` px at
    `angle` (videostab's deblurring slot), one forward and one inverse
    complex64 FFT. Runs on the card unless `device="cpu"`."""
    frame = torch.as_tensor(frame, device=resolve_device(device)).to(torch.float32)
    h, w = frame.shape
    length = max(int(round(motion_px)), 1)
    psf = np.zeros((h, w), np.float32)
    c, s = np.cos(angle), np.sin(angle)
    for i in range(length):
        t = i - (length - 1) / 2.0  # symmetric taps about the origin
        psf[int(round(t * s)) % h, int(round(t * c)) % w] += 1.0
    psf /= psf.sum()
    hf = torch.fft.rfft2(torch.from_numpy(psf).to(frame.device))
    ff = torch.fft.rfft2(frame)
    mag = hf.abs()
    wiener = torch.conj(hf) / (mag * mag + 1.0 / snr)
    return torch.fft.irfft2(ff * wiener, s=(h, w)).clamp(0.0, 255.0)


def inpaint_borders(frames: list[np.ndarray], masks: list[np.ndarray]) -> list[np.ndarray]:
    """Fill the empty borders that warps leave from neighbouring frames
    (videostab's inpainting slot): each invalid pixel takes the median of
    the valid values of the frames up to two away."""
    out = []
    n = len(frames)
    for i, (f, m) in enumerate(zip(frames, masks)):
        f = np.asarray(f, np.float32).copy()
        m = np.asarray(m, bool)
        hole = ~m
        if hole.any():
            cand = []
            for j in range(max(0, i - 2), min(n, i + 3)):
                if j == i:
                    continue
                fj = np.asarray(frames[j], np.float32)
                mj = np.asarray(masks[j], bool)
                cand.append(np.where(mj, fj, np.nan))
            if cand:
                med = np.nanmedian(np.stack(cand), axis=0)
                fill = np.where(np.isnan(med), f, med)
                f[hole] = fill[hole]
        out.append(f)
    return out


def suppress_wobble(motions: np.ndarray, period: int = 2, strength: float = 1.0,
                    device=None) -> np.ndarray:
    """Wobble suppression (videostab's wobble-suppression slot): the
    detrended per-frame affine params [T, 2, 3] lose their frequency band
    from 1 / (2 period) cycles per frame to Nyquist (scaled by
    `strength`), one real FFT over time. Returns [T, 2, 3]. Runs on the
    card unless `device="cpu"`."""
    dev = resolve_device(device)
    t_len = len(motions)
    m = torch.as_tensor(np.asarray(motions, np.float32).reshape(t_len, -1), device=dev)
    t = torch.arange(t_len, dtype=torch.float32, device=dev)
    tc = t - t.mean()
    with no_tf32():
        slope = (tc @ m) / torch.clamp(tc @ tc, min=1e-9)
    # detrend first: a ramp would leak into every bin
    trend = m.mean(0)[None] + tc[:, None] * slope[None]
    spec = torch.fft.rfft(m - trend, dim=0)
    freqs = torch.fft.rfftfreq(t_len, device=dev)
    notch = torch.where(freqs[:, None] >= 1.0 / (2.0 * period), 1.0 - strength, 1.0)
    out = torch.fft.irfft(spec * notch, n=t_len, dim=0) + trend
    return out.cpu().numpy().reshape(t_len, 2, 3)
