"""Five-point minimal essential-matrix solver (Nister 2004), batched over
leading dimensions (port of opencv_tpu/geometry/five_point.py).

Stages, as in the JAX solver:
- the 4-dim nullspace of the 5x9 design: the last four columns of a
  complete Householder QR of A^T (`epipolar._householder_null`, LAPACK's
  reflectors written out, so the CPU and the card build the same basis);
- the ten cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0) as
  einsums against constant 0/1 monomial-product tensors;
- Gauss-Jordan by one batched 10x10 solve, Nister's hidden-variable 3x3
  matrix B(z) and its degree-10 determinant;
- roots by a Durand-Kerner iteration on f32 (re, im) pairs;
- every root gives a candidate E; RANSAC scores all of them.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.geometry.epipolar import _householder_null

# ---- static monomial tables ------------------------------------------------

# degree-1 basis over (x, y, z, 1)
_E1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# monomials of total degree <= 2 in (x, y, z)
_E2 = [(i, j, k) for i in range(3) for j in range(3) for k in range(3) if i + j + k <= 2]
# Nister's degree-<=3 order: x,y-degree >= 2 first, then the tail
_M3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_M3_INDEX = {m: i for i, m in enumerate(_M3)}
_E2_INDEX = {m: i for i, m in enumerate(_E2)}


def _product_table(left, right, index) -> np.ndarray:
    """0/1 [len(left), len(right), len(index)]: monomial i times j."""
    t = np.zeros((len(left), len(right), len(index)), np.float32)
    for i, a in enumerate(left):
        for j, b in enumerate(right):
            t[i, j, index[tuple(np.add(a, b))]] = 1.0
    return t


_MUL_11 = _product_table(_E1, _E1, _E2_INDEX)  # [4, 4, 10]
_MUL_21 = _product_table(_E2, _E1, _M3_INDEX)  # [10, 4, 20]
_LEVI = np.zeros((3, 3, 3), np.float32)
for _p in itertools.permutations(range(3)):
    _LEVI[_p] = np.linalg.det(np.eye(3)[list(_p)])


def _conv_table(n: int, m: int) -> np.ndarray:
    """0/1 [n, m, n+m-1]: coefficient i times coefficient j -> i+j."""
    t = np.zeros((n, m, n + m - 1), np.float32)
    for i in range(n):
        for j in range(m):
            t[i, j, i + j] = 1.0
    return t


_CONV_55 = _conv_table(5, 5)
_CONV_95 = _conv_table(9, 5)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


# ---- solver ----------------------------------------------------------------


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """basis [..., 4, 3, 3] (E = x B0 + y B1 + z B2 + B3) -> M [..., 10, 20]."""
    e = basis.movedim(-3, -1)  # [..., 3, 3, 4]: E entries as degree-1 polys
    p11 = _const(_MUL_11, basis)
    p21 = _const(_MUL_21, basis)
    p3 = torch.einsum("ijl,lkm->ijkm", p11, p21)  # deg1 * deg1 * deg1 -> deg3
    det = torch.einsum("abc,...ai,...bj,...ck,ijkm->...m", _const(_LEVI, basis),
                       e[..., 0, :, :], e[..., 1, :, :], e[..., 2, :, :], p3)
    # B = E E^T (degree 2), C = 2 B E - tr(B) E (degree 3)
    B = torch.einsum("...ikp,...jkq,pql->...ijl", e, e, p11)
    trB = B[..., 0, 0, :] + B[..., 1, 1, :] + B[..., 2, 2, :]
    C = (2.0 * torch.einsum("...ikl,...kjq,lqm->...ijm", B, e, p21)
         - torch.einsum("...l,...ijq,lqm->...ijm", trB, e, p21))
    return torch.cat([det[..., None, :], C.flatten(-3, -2)], dim=-2)


def _poly_b_matrix(tail: torch.Tensor) -> torch.Tensor:
    """tail [..., 10, 10] over the tail monomials [xz^2, xz, x, yz^2, yz, y,
    z^3, z^2, z, 1] -> B [..., 3, 3, 5]: z-polynomials (constant first) of
    the three hidden-variable equations' (x, y, 1) coefficients."""
    zero = torch.zeros_like(tail[..., 0, 0])

    def combo(r_hi, r_lo):
        t = tail[..., r_hi, :]
        s = tail[..., r_lo, :]
        cx = torch.stack([t[..., 2], t[..., 1] - s[..., 2], t[..., 0] - s[..., 1], -s[..., 0], zero], -1)
        cy = torch.stack([t[..., 5], t[..., 4] - s[..., 5], t[..., 3] - s[..., 4], -s[..., 3], zero], -1)
        c1 = torch.stack([t[..., 9], t[..., 8] - s[..., 9], t[..., 7] - s[..., 8],
                          t[..., 6] - s[..., 7], -s[..., 6]], -1)
        return torch.stack([cx, cy, c1], -2)

    return torch.stack([combo(4, 5), combo(6, 7), combo(8, 9)], -3)


def _poly_det3(B: torch.Tensor) -> torch.Tensor:
    """det of [..., 3, 3, 5] z-polynomials -> degree-10 coefficients
    [..., 11], constant first (degrees 11 and 12 cancel exactly)."""
    det = torch.einsum("abc,...ai,...bj,...ck,ijl,lkm->...m", _const(_LEVI, B),
                       B[..., 0, :, :], B[..., 1, :, :], B[..., 2, :, :],
                       _const(_CONV_55, B), _const(_CONV_95, B))
    return det[..., :11]


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _durand_kerner(coeffs: torch.Tensor, iters: int = 80) -> tuple[torch.Tensor, torch.Tensor]:
    """Roots of degree-10 polynomials (coeffs [..., 11], constant first) by
    Durand-Kerner on (re, im) pairs, with the JAX solver's Cauchy-bound
    scaling and step clamping. Returns (re [..., 10], im [..., 10])."""
    dev, dt = coeffs.device, coeffs.dtype
    lead = coeffs[..., 10]
    safe = torch.where(lead.abs() < 1e-20, torch.full_like(lead, 1e-20), lead)
    monic = coeffs / safe[..., None]
    ks = torch.arange(10, device=dev, dtype=dt)
    mags = monic[..., :10].abs() ** (1.0 / (10.0 - ks))
    s = mags.amax(dim=-1).clamp(1e-3, 1e6)
    scaled = monic * s[..., None] ** (torch.arange(11, device=dev, dtype=dt) - 10.0)

    r0 = 1.3 * (0.4 + 0.9j) ** np.arange(1, 11)
    shape = coeffs.shape[:-1] + (10,)
    re = torch.as_tensor(np.real(r0), dtype=dt, device=dev).expand(shape)
    im = torch.as_tensor(np.imag(r0), dtype=dt, device=dev).expand(shape)
    eye = torch.eye(10, dtype=dt, device=dev)
    for _ in range(iters):
        pr = scaled[..., 10:11].expand(shape)
        pi = torch.zeros_like(im)
        for k in range(9, -1, -1):
            pr, pi = _cmul(pr, pi, re, im)
            pr = pr + scaled[..., k : k + 1]
        # prod_j (r_i - r_j), the diagonal replaced by 1: a pairwise tree
        dr = re[..., :, None] - re[..., None, :] + eye
        di = im[..., :, None] - im[..., None, :]
        while dr.shape[-1] > 1:
            n = dr.shape[-1]
            h = n // 2
            mr, mi = _cmul(dr[..., :h], di[..., :h], dr[..., h : 2 * h], di[..., h : 2 * h])
            if n % 2:
                mr = torch.cat([mr, dr[..., -1:]], -1)
                mi = torch.cat([mi, di[..., -1:]], -1)
            dr, di = mr, mi
        nr, ni = dr[..., 0], di[..., 0]
        tiny = torch.sqrt(nr * nr + ni * ni) < 1e-20
        nr = torch.where(tiny, torch.full_like(nr, 1e-20), nr)
        ni = torch.where(tiny, torch.zeros_like(ni), ni)
        d2 = nr * nr + ni * ni
        sr = (pr * nr + pi * ni) / d2
        si = (pi * nr - pr * ni) / d2
        mag = torch.sqrt(sr * sr + si * si)
        clip = torch.where(mag > 10.0, 10.0 / mag, torch.ones_like(mag))
        re, im = re - sr * clip, im - si * clip
    return re * s[..., None], im * s[..., None]


class FivePointResult(NamedTuple):
    E: torch.Tensor  # [..., 10, 3, 3] candidates
    valid: torch.Tensor  # [..., 10]


def five_point(x1: torch.Tensor, x2: torch.Tensor) -> FivePointResult:
    """Essential-matrix candidates from 5 normalized correspondences
    [..., 5, 2] each."""
    one = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, one], -1)
    p2 = torch.cat([x2, one], -1)
    A = (p2[..., :, :, None] * p1[..., :, None, :]).flatten(-2)  # [..., 5, 9]
    # A Q[:, 5:] = R^T[:, 5:] = 0 for any rank (degenerate samples too)
    basis = _householder_null(A, cols=4).transpose(-1, -2).reshape(A.shape[:-2] + (4, 3, 3))

    M = _constraint_matrix(basis)  # [..., 10, 20]
    lhs = M[..., :10]
    ok = torch.linalg.det(lhs).abs() > 1e-20
    eye = torch.eye(10, dtype=M.dtype, device=M.device)
    okf = ok[..., None, None].to(M.dtype)
    tail = torch.linalg.solve_ex(okf * lhs + (1.0 - okf) * eye, M[..., 10:])[0]
    B = _poly_b_matrix(tail)  # [..., 3, 3, 5]
    re, im = _durand_kerner(_poly_det3(B))  # [..., 10]

    real = im.abs() < 1e-4 * (1.0 + re.abs())
    z = re
    zp = z[..., None] ** torch.arange(5, device=z.device, dtype=z.dtype)  # [..., 10, 5]
    Bz = torch.einsum("...ijk,...rk->...rij", B, zp)  # [..., 10, 3, 3]
    # nullspace of B(z) from the largest cross product of two rows
    cands = torch.stack([torch.linalg.cross(Bz[..., 0, :], Bz[..., 1, :]),
                         torch.linalg.cross(Bz[..., 0, :], Bz[..., 2, :]),
                         torch.linalg.cross(Bz[..., 1, :], Bz[..., 2, :])], -2)
    pick = torch.argmax((cands * cands).sum(-1), dim=-1)
    nvec = torch.gather(cands, -2, pick[..., None, None].expand(pick.shape + (1, 3)))[..., 0, :]
    w = torch.where(nvec[..., 2].abs() < 1e-12, torch.full_like(z, 1e-12), nvec[..., 2])
    x = nvec[..., 0] / w
    y = nvec[..., 1] / w
    bs = basis[..., None, :, :, :]  # [..., 1, 4, 3, 3]
    E = (x[..., None, None] * bs[..., 0, :, :] + y[..., None, None] * bs[..., 1, :, :]
         + z[..., None, None] * bs[..., 2, :, :] + bs[..., 3, :, :])
    nrm = torch.linalg.matrix_norm(E)
    E = E / nrm.clamp(min=1e-12)[..., None, None]
    # residual filter: an imprecise root satisfies the 5 epipolar
    # constraints but sits off the essential manifold
    det_res = torch.linalg.det(E).abs()
    EEt = E @ E.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    C = 2.0 * EEt @ E - tr[..., None, None] * E
    good = (nrm > 1e-12) & (det_res < 5e-3) & (C.abs().amax(dim=(-1, -2)) < 5e-3)
    valid = real & good & ok[..., None] & torch.isfinite(E).all(dim=(-1, -2))
    return FivePointResult(E=E, valid=valid)
