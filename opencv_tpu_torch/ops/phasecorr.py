"""Phase-correlation translation registration + Hanning window (port of
opencv_tpu/ops/phasecorr.py; imgproc/src/phasecorr.cpp:513 phaseCorrelate,
:597 createHanningWindow, :432 weightedCentroid).

Two 2-D FFTs (`torch.fft`: pocketfft on the CPU, cuFFT on the card, where
the JAX package has XLA's), the normalized cross-power spectrum, the
inverse FFT with numpy's 1/(MN) normalisation, the argmax and the
reference's 5x5 weighted centroid clamped at the borders (a mask). The
FFTs round otherwise than XLA's, so the peak agrees to about 1e-3 px.
"""

from __future__ import annotations

import math

import torch

from opencv_tpu_torch.device import on_device, resolve_device, true_div


def create_hanning_window(h: int, w: int, device=None) -> torch.Tensor:
    """Separable 2-D Hann weighting (phasecorr.cpp:597)."""
    dev = resolve_device(device)

    def hann(n):
        k = 2.0 * math.pi * torch.arange(n, device=dev)
        return 0.5 * (1.0 - torch.cos(true_div(k, n - 1)))

    # the reference sqrt's the separable product (phasecorr.cpp:639)
    return torch.sqrt(hann(h)[:, None] * hann(w)[None, :])


def phase_correlate(src1, src2, window=None, device=None):
    """Sub-pixel translation of src2 relative to src1 (phasecorr.cpp:513).

    Returns ((dx, dy), response) as f32 scalars: src2(x) ~ src1(x - (dx,
    dy)); response is the normalized peak energy in [0, 1]-ish (1 =
    perfect periodic shift), the reference's *response out-param."""
    a = on_device(src1, device).to(torch.float32)
    b = on_device(src2, a.device).to(torch.float32)
    dev = a.device
    if window is not None:
        window = on_device(window, dev)
        a = a * window
        b = b * window
    m, n = a.shape

    p = torch.fft.fft2(a) * torch.conj(torch.fft.fft2(b))
    c = torch.fft.ifft2(p / torch.clamp(torch.abs(p), min=1e-20)).real
    c = torch.fft.fftshift(c)

    peak = torch.argmax(c)
    py = peak // n
    px = peak % n

    # 5x5 weighted centroid, clamped at the borders exactly like the
    # reference (rows/cols outside the image simply don't contribute)
    yy = torch.arange(m, device=dev)[:, None]
    xx = torch.arange(n, device=dev)[None, :]
    in_box = ((yy - py).abs() <= 2) & ((xx - px).abs() <= 2)
    wgt = torch.where(in_box, c, torch.zeros_like(c))
    s = wgt.sum()
    # ifft2 is 1/(MN)-normalized where the reference's idft is not, so its
    # final "/= M*N" (phasecorr.cpp:588) is already folded in
    response = s
    s = s + torch.finfo(torch.float32).eps
    tx = (wgt * xx).sum() / s
    ty = (wgt * yy).sum() / s
    return (n / 2.0 - tx, m / 2.0 - ty), response
