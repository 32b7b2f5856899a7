"""Template matching (port of opencv_tpu/ops/template.py; cv::matchTemplate,
imgproc/src/templmatch.cpp, cudaimgproc/src/cuda/match_template.cu).

The correlation is one VALID `F.conv2d` in true f32 (`no_tf32`): a plain
product that the JAX package also leaves to its library (XLA's
convolution), summed in another order, so scores agree to a relative
1e-6 or so and the best location is the same. The window sums come from
the port's `imgproc.integral` (XLA's prefix-sum order: bit-equal), and
every division is by a device tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import no_tf32, on_device, true_div

METHODS = ("sqdiff", "sqdiff_normed", "ccorr", "ccorr_normed", "ccoeff", "ccoeff_normed")


def _valid_corr(img: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation [H-th+1, W-tw+1]."""
    with no_tf32():
        return F.conv2d(img[None, None], tmpl[None, None])[0, 0]


def _window_sums(img: torch.Tensor, th: int, tw: int):
    """(sum, sum_sq) of every template-sized window (VALID)."""
    ii = imgproc.integral(img)
    ii2 = imgproc.integral(img * img)

    def win(i):
        return i[th:, tw:] - i[th:, :-tw] - i[:-th, tw:] + i[:-th, :-tw]

    return win(ii), win(ii2)


def match_template(img, tmpl, method: str = "ccoeff_normed", device=None) -> torch.Tensor:
    """Score map [H-th+1, W-tw+1]. Methods: sqdiff, sqdiff_normed, ccorr,
    ccorr_normed, ccoeff, ccoeff_normed (TM_* analogs)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method}")
    img = on_device(img, device).to(torch.float32)
    tmpl = on_device(tmpl, img.device).to(torch.float32)
    th, tw = tmpl.shape
    n = th * tw
    corr = _valid_corr(img, tmpl)
    wsum, wsum2 = _window_sums(img, th, tw)
    t_sum = tmpl.sum()
    t_sum2 = (tmpl * tmpl).sum()
    eps = 1e-9

    if method == "ccorr":
        return corr
    if method == "ccorr_normed":
        return corr / (torch.sqrt(wsum2 * t_sum2) + eps)
    if method == "sqdiff":
        return wsum2 - 2.0 * corr + t_sum2
    if method == "sqdiff_normed":
        return (wsum2 - 2.0 * corr + t_sum2) / (torch.sqrt(wsum2 * t_sum2) + eps)
    # ccoeff: subtract means
    cc = corr - wsum * true_div(t_sum, n)
    if method == "ccoeff":
        return cc
    t_var = t_sum2 - true_div(t_sum * t_sum, n)
    w_var = wsum2 - true_div(wsum * wsum, n)
    return cc / (torch.sqrt(torch.clamp(t_var * w_var, min=0.0)) + eps)
