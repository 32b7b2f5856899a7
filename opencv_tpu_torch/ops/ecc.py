"""ECC image alignment (port of opencv_tpu/ops/ecc.py; cv::findTransformECC).

Estimates a translation, euclidean or affine warp that maximizes the
enhanced correlation coefficient between a template and an image, by
damped Gauss-Newton with forward-mode Jacobians (`torch.func.jacfwd`)
straight through the bilinear warp, as the JAX package does with
`jax.jacfwd`. The 50 LM iterations stay on the device: accept or reject
is a `torch.where`, the 6x6 solve does not check for errors, so no
iteration reads the host. Matrix products run in true f32 (TF32 off),
the JAX package's Precision.HIGHEST.
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import no_tf32, resolve_device

_N_PARAMS = {"translation": 2, "euclidean": 3, "affine": 6}


def _warp_params_to_matrix(params: torch.Tensor, motion: str) -> torch.Tensor:
    """[2, 3] warp of the motion model's parameters (zero: identity)."""
    if motion == "translation":
        one, zero = torch.ones_like(params[0]), torch.zeros_like(params[0])
        return torch.stack([torch.stack([one, zero, params[0]]),
                            torch.stack([zero, one, params[1]])])
    if motion == "euclidean":
        th, tx, ty = params
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([torch.stack([c, -s, tx]), torch.stack([s, c, ty])])
    if motion == "affine":
        eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=params.dtype,
                           device=params.device)
        return params.reshape(2, 3) + eye
    raise ValueError(f"unknown motion model {motion}")


def find_transform_ecc(template, image, motion: str = "affine", iters: int = 50, init=None,
                       device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(warp [2, 3] mapping template coordinates to image coordinates,
    final correlation coefficient). The correlation is taken inside a 10 %
    margin so that pixels warped in from the border do not bias it. Runs
    on the card unless `device="cpu"`."""
    if motion not in _N_PARAMS:
        raise ValueError(f"unknown motion model {motion}")
    dev = resolve_device(device)
    template = torch.as_tensor(template, device=dev).to(torch.float32)
    image = torch.as_tensor(image, device=dev).to(torch.float32)
    h, w = template.shape
    my, mx = max(h // 10, 2), max(w // 10, 2)

    t_crop = template[my:h - my, mx:w - mx]
    t0 = t_crop - t_crop.mean()
    t0 = t0 / torch.clamp(torch.linalg.vector_norm(t0), min=1e-9)

    def residual(params):
        m = _warp_params_to_matrix(params, motion)
        warped = imgproc.warp_affine(image, m, h, w)[my:h - my, mx:w - mx]
        wz = warped - warped.mean()
        wz = wz / torch.clamp(torch.linalg.vector_norm(wz), min=1e-9)
        return (wz - t0).reshape(-1)

    n = _N_PARAMS[motion]
    params = (torch.zeros(n, dtype=torch.float32, device=dev) if init is None
              else torch.as_tensor(init, dtype=torch.float32, device=dev))
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    jac = torch.func.jacfwd(residual)
    with no_tf32():
        for _ in range(iters):
            r = residual(params)
            J = jac(params)
            H = J.T @ J
            g = J.T @ r
            step = torch.linalg.solve_ex(H + lam * eye, g).result
            new = params - step
            better = (residual(new) ** 2).sum() < (r * r).sum()
            params = torch.where(better, new, params)
            lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        r = residual(params)
    ecc = 1.0 - 0.5 * (r * r).sum()  # ||a - b||^2 = 2 - 2 rho for unit vectors
    return _warp_params_to_matrix(params, motion), ecc
