"""Exposure compensation and timelapser for the panorama pipeline (port of
opencv_tpu/stitching/exposure.py; reference
modules/stitching/src/exposure_compensate.cpp GainCompensator :85-182,
BlocksGainCompensator :300+; timelapsers.cpp).

Every image is already warped onto the shared canvas, so the pairwise
overlap statistics are masked reductions over aligned tensors (two
matmuls), and the block compensator solves all blocks' small systems in
one batched solve. Both run with TF32 off; their sums and the solve are
ordered by the library, so the gains agree with the JAX package to a
tolerance. The block gains are upsampled by `_resize_linear`, the port's
counterpart of `jax.image.resize(..., "bilinear")` (not the package's
`resize_bilinear`).
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import no_tf32

_ALPHA = 0.01
_BETA = 100.0
# the reference measures per-pixel sqrt(r^2+g^2+b^2) (exposure_
# compensate.cpp:131): a gray triplet is gray*sqrt(3)
_RGB_NORM = 3.0 ** 0.5


def _solve_gains(Nmat: torch.Tensor, Imat: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The reference's gain normal equations (exposure_compensate.cpp:
    141-166), batched over leading dims. Nmat/Imat: [..., n, n]; skip:
    [..., n] images with no overlap (gain forced to 1)."""
    n = Nmat.shape[-1]
    keep = ~skip
    kf = keep.to(torch.float32)
    pair = kf[..., :, None] * kf[..., None, :]
    Nk = Nmat * pair
    eye = torch.eye(n, dtype=torch.float32, device=Nmat.device)
    off = 1.0 - eye
    b = _BETA * Nk.sum(-1)
    diag = _BETA * Nk.sum(-1) + 2.0 * _ALPHA * (off * Imat ** 2 * Nk).sum(-1)
    A = -2.0 * _ALPHA * Imat * Imat.transpose(-1, -2) * Nk * off + diag[..., :, None] * eye
    # skipped images: identity row -> gain 1
    A = torch.where(keep[..., :, None] & keep[..., None, :], A, eye)
    b = torch.where(keep, b, 1.0)
    with no_tf32():
        gains = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    return torch.where(keep, gains, 1.0)


def _pair_stats(stack: torch.Tensor, masks: torch.Tensor):
    """N (overlap counts) and I (mean overlap intensity of image i
    against each j) from canvas-aligned images/masks [n, H, W]."""
    n = masks.shape[0]
    mf = masks.to(torch.float32).reshape(n, -1)
    with no_tf32():
        inter = mf @ mf.T  # pixel counts (incl. i == i)
        Isum = ((stack.reshape(n, -1) * _RGB_NORM) * mf) @ mf.T
    Nmat = inter.clamp(min=1.0)
    Imat = Isum / Nmat
    off = ~torch.eye(n, dtype=torch.bool, device=masks.device)
    has_overlap = ((inter > 0) & off).any(dim=1)
    return Nmat, Imat, ~has_overlap


def _stack(images, masks):
    """[n, H, W] f32 images and bool masks on the device of images[0]."""
    dev = torch.as_tensor(images[0]).device
    stack = torch.stack([torch.as_tensor(im, device=dev).to(torch.float32) for im in images])
    mstack = torch.stack([torch.as_tensor(m, device=dev).to(torch.bool) for m in masks])
    return stack, mstack


def gain_compensate(images, masks):
    """GainCompensator: one multiplicative gain per image minimizing
    overlap intensity mismatch. images/masks: lists of [H, W] canvas
    tensors on one device. Returns (compensated images list, gains [n])."""
    stack, mstack = _stack(images, masks)
    Nmat, Imat, skip = _pair_stats(stack, mstack)
    gains = _solve_gains(Nmat, Imat, skip)
    return [im * gains[i] for i, im in enumerate(stack)], gains


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image's triangle-kernel weight matrix [n_in, n_out] for an
    upsampling (compute_weight_mat with scale n_out / n_in, translation 0,
    antialias on: the kernel is not widened), in f32 as it is built
    there: weights normalized by their column sum, zero where the sample
    falls outside the input."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    wts = (1.0 - x.abs()).clamp(min=0.0)
    total = wts.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    wts = torch.where(total.abs() > eps, wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def _resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """jax.image.resize(x, (n, out_h, out_w), "bilinear") of [n, h, w] for
    out_h >= h and out_w >= w: one weight matrix per resized axis (an axis
    of equal size is left alone, as there), contracted rows first with
    TF32 off. The contraction's sums are ordered by the library."""
    _, h, w = x.shape
    with no_tf32():
        if out_h != h:
            x = torch.einsum("nhw,hp->npw", x, _linear_weights(h, out_h, x.device))
        if out_w != w:
            x = torch.einsum("npw,wq->npq", x, _linear_weights(w, out_w, x.device))
    return x


def block_gain_compensate(images, masks, block: int = 32, smooth_sigma: float = 1.0):
    """BlocksGainCompensator: per-block gains solved jointly across images
    (batched over blocks), then smoothed and bilinearly upsampled to a
    per-pixel gain map. Returns (compensated images, gain maps)."""
    stack, mstack = _stack(images, masks)
    n, h, w = stack.shape
    hb = -(-h // block)
    wb = -(-w // block)
    ph, pw = hb * block, wb * block
    spad = torch.nn.functional.pad(stack, (0, pw - w, 0, ph - h))
    mpad = torch.nn.functional.pad(mstack, (0, pw - w, 0, ph - h))

    def blocksum(x):  # [n, hb, wb]
        return x.reshape(n, hb, block, wb, block).sum(dim=(2, 4))

    mf = mpad.to(torch.float32)
    cnt = blocksum(mf)
    ssum = blocksum(spad * mf)

    # per block: N_ij = min of the two block counts (the aligned-canvas
    # analog of the reference's per-block intersect), I_ij = block mean
    cb = cnt.reshape(n, -1).T  # [B, n]
    sb = ssum.reshape(n, -1).T
    inter = torch.minimum(cb[:, :, None], cb[:, None, :])  # [B, n, n]
    Nmat = inter.clamp(min=1.0)
    mean_i = sb * _RGB_NORM / cb.clamp(min=1.0)
    Imat = mean_i[:, :, None].expand(inter.shape)
    present = cb > 0
    off = ~torch.eye(n, dtype=torch.bool, device=stack.device)
    overlap = (inter > 0) & off[None]
    skip = ~(present & overlap.any(dim=2))

    gains_b = _solve_gains(Nmat, Imat, skip)  # [B, n]
    gmap = gains_b.T.reshape(n, hb, wb)
    if smooth_sigma > 0:
        gmap = imgproc.gaussian_blur(gmap, 3, smooth_sigma)
    gfull = _resize_linear(gmap, ph, pw)[:, :h, :w]
    return [stack[i] * gfull[i] for i in range(n)], gfull


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def timelapse(images, masks, crop: bool = False) -> list[np.ndarray]:
    """Timelapser (timelapsers.cpp): one output canvas per input frame
    with just that warped frame placed (AS_IS), optionally cropped to the
    union bounding box (CROP). Host numpy, as in the JAX package."""
    mstack = np.stack([_np(m).astype(bool) for m in masks])
    union = mstack.any(axis=0)
    ys, xs = np.where(union)
    if crop and len(ys):
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
    else:
        y0, y1, x0, x1 = 0, union.shape[0], 0, union.shape[1]
    out = []
    for im, m in zip(images, mstack):
        frame = np.where(m, _np(im), 0.0)
        out.append(frame[y0:y1, x0:x1])
    return out
