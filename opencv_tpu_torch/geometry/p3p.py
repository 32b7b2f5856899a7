"""P3P minimal pose solver, batched over leading dimensions (port of
opencv_tpu/geometry/p3p.py).

Grunert's distance system reduces, with u = s2/s1 and v = s3/s1, to two
quadratics in u whose resultant is a quartic in v. Its coefficients come
from five evaluations and a constant inverse Vandermonde; the roots from
a Durand-Kerner iteration on f32 (re, im) pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.geometry.rotation import project_to_rotation, rodrigues_inv

_V_NODES = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
_VANDER_INV = np.linalg.inv(np.vander(_V_NODES, 5, increasing=True)).astype(np.float32)
_R0 = 1.3 * (0.4 + 0.9j) ** np.arange(1, 5)  # Durand-Kerner start points


def _durand_kerner(coeffs: torch.Tensor, iters: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """All 4 complex roots of c0 + c1 v + ... + c4 v^4, coeffs [..., 5];
    returns (re [..., 4], im [..., 4]). Cauchy-bound scaling and step
    clamping as in the JAX solver."""
    dev = coeffs.device
    lead = coeffs[..., 4]
    safe = torch.where(lead.abs() < 1e-20, torch.full_like(lead, 1e-20), lead)
    monic = coeffs / safe[..., None]
    expo = torch.tensor([1.0 / 4.0, 1.0 / 3.0, 1.0 / 2.0, 1.0], dtype=coeffs.dtype, device=dev)
    mags = monic[..., :4].abs() ** expo
    s = mags.amax(dim=-1).clamp(1e-3, 1e6)
    scaled = monic * s[..., None] ** (torch.arange(5, device=dev, dtype=coeffs.dtype) - 4.0)

    re = torch.as_tensor(np.real(_R0), dtype=coeffs.dtype, device=dev).expand(coeffs.shape[:-1] + (4,))
    im = torch.as_tensor(np.imag(_R0), dtype=coeffs.dtype, device=dev).expand(coeffs.shape[:-1] + (4,))
    eye4 = torch.eye(4, dtype=coeffs.dtype, device=dev)
    for _ in range(iters):
        ar = scaled[..., 4:5].expand_as(re)
        ai = torch.zeros_like(im)
        for k in range(3, -1, -1):
            ar, ai = ar * re - ai * im + scaled[..., k : k + 1], ar * im + ai * re
        dr = re[..., :, None] - re[..., None, :] + eye4
        di = im[..., :, None] - im[..., None, :]
        nr, ni = dr[..., :, 0], di[..., :, 0]
        for j in range(1, 4):
            nr, ni = nr * dr[..., :, j] - ni * di[..., :, j], nr * di[..., :, j] + ni * dr[..., :, j]
        d2 = nr * nr + ni * ni
        d2 = torch.where(d2 < 1e-40, torch.full_like(d2, 1e-40), d2)
        sr = (ar * nr + ai * ni) / d2
        si = (ai * nr - ar * ni) / d2
        mag = torch.sqrt(sr * sr + si * si)
        clip = torch.where(mag > 10.0, 10.0 / mag, torch.ones_like(mag))
        re, im = re - sr * clip, im - si * clip
    return re * s[..., None], im * s[..., None]


def _kabsch3(Y: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rigid transform with Y_i ~= R @ X_i + t for 3 correspondences
    ([..., 3, 3] point rows)."""
    muY = Y.mean(dim=-2)
    muX = X.mean(dim=-2)
    H = torch.einsum("...ni,...nj->...ij", Y - muY[..., None, :], X - muX[..., None, :])
    R = project_to_rotation(H)
    t = muY - torch.einsum("...ij,...j->...i", R, muX)
    return R, t


def p3p_solutions(
    obj: torch.Tensor, bearings: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All P3P candidates. obj [..., 3, 3] world points, bearings [..., 3, 3]
    unit rays. Returns (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4])."""
    dev = obj.device
    a2 = ((obj[..., 1, :] - obj[..., 2, :]) ** 2).sum(-1)
    b2 = ((obj[..., 0, :] - obj[..., 2, :]) ** 2).sum(-1)
    c2 = ((obj[..., 0, :] - obj[..., 1, :]) ** 2).sum(-1)
    ca = (bearings[..., 1, :] * bearings[..., 2, :]).sum(-1)
    cb = (bearings[..., 0, :] * bearings[..., 2, :]).sum(-1)
    cg = (bearings[..., 0, :] * bearings[..., 1, :]).sum(-1)
    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    rb = a2 / b2s
    rc = c2 / b2s

    def quad(v, rb, rc, ca, cb, cg):
        c1 = 1.0 - rc * (1.0 + v * v - 2.0 * v * cb)
        c2_ = v * v - rb * (1.0 + v * v - 2.0 * v * cb)
        b1 = -2.0 * cg
        b2_ = -2.0 * ca * v
        return c1, c2_, b1, b2_

    nodes = torch.as_tensor(_V_NODES, device=dev)
    c1, c2_, b1, b2_ = quad(nodes, *(x[..., None] for x in (rb, rc, ca, cb, cg)))
    dc = c1 - c2_
    db = b1 - b2_
    evals = dc * dc - b1 * dc * db + c1 * db * db  # [..., 5]
    coeffs = torch.einsum("ij,...j->...i", torch.as_tensor(_VANDER_INV, device=dev), evals)
    lead_ok = coeffs[..., 4].abs() > 1e-10 * (coeffs.abs().amax(dim=-1) + 1e-20)
    v, v_im = _durand_kerner(coeffs)  # [..., 4]

    is_real = v_im.abs() < 1e-3 * (1.0 + v.abs())
    c1, c2_, b1, b2_ = quad(v, *(x[..., None] for x in (rb, rc, ca, cb, cg)))
    db = b1 - b2_
    db_safe = torch.where(db.abs() < 1e-9, torch.ones_like(db), db)
    u = torch.where(db.abs() > 1e-9, -(c1 - c2_) / db_safe, torch.zeros_like(db))
    d1 = 1.0 + u * u - 2.0 * u * cg[..., None]
    s1 = torch.sqrt(c2[..., None] / torch.where(d1 < 1e-12, torch.full_like(d1, 1e-12), d1))
    s2 = u * s1
    s3 = v * s1
    ok = is_real & (v > 1e-6) & (u > 1e-6) & (d1 > 1e-12)
    br = bearings[..., None, :, :]  # [..., 1, 3, 3]
    Y = torch.stack(
        [s1[..., None] * br[..., 0, :], s2[..., None] * br[..., 1, :], s3[..., None] * br[..., 2, :]],
        dim=-2,
    )  # [..., 4, 3, 3]
    R, t = _kabsch3(Y, obj[..., None, :, :].expand_as(Y))
    ok &= torch.isfinite(R).all(dim=(-1, -2)) & torch.isfinite(t).all(dim=-1)
    return R, t, ok & lead_ok[..., None]


def p3p_kernel(obj: torch.Tensor, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RANSAC minimal kernel: P3P on points 0-2, disambiguated by point 3,
    then three Gauss-Newton steps on all four points.
    obj [..., 4, 3], img [..., 4, 2] normalized. Returns (model [..., 6]
    = rvec|tvec, ok [...])."""
    from opencv_tpu_torch.geometry.pnp import gn_refine_pose

    rays = torch.cat([img[..., :3, :], torch.ones_like(img[..., :3, :1])], dim=-1)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    R, t, valid = p3p_solutions(obj[..., :3, :], rays)

    pc = torch.einsum("...rij,...j->...ri", R, obj[..., 3, :]) + t  # [..., 4, 3]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    e = ((pc[..., :2] / zs[..., None] - img[..., None, 3, :]) ** 2).sum(-1)
    inf = torch.full_like(e, float("inf"))
    errs = torch.where(valid & (z > 1e-6), e, inf)
    best = torch.argmin(errs, dim=-1)
    err_b = torch.gather(errs, -1, best[..., None])[..., 0]
    ok = torch.isfinite(err_b)
    Rb = torch.gather(R, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    tb = torch.gather(t, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    rvec = rodrigues_inv(Rb)
    rvec, tvec = gn_refine_pose(rvec, tb, obj, img, torch.ones_like(obj[..., 0]), iters=3)
    model = torch.cat([rvec, tvec], dim=-1)
    ok &= torch.isfinite(model).all(dim=-1)
    return torch.where(ok[..., None], model, torch.zeros_like(model)), ok
