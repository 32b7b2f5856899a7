"""Matrix decompositions (port of opencv_tpu/geometry/decompose.py):
homography -> motion candidates, projection matrix -> K/R/C, and Bouguet
stereo rectification."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.geometry.rotation import project_to_rotation, rodrigues, rodrigues_inv


class HomographyDecomposition(NamedTuple):
    R: torch.Tensor  # [4, 3, 3]
    t: torch.Tensor  # [4, 3] (up to scale)
    n: torch.Tensor  # [4, 3] plane normals
    valid: torch.Tensor  # [4]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v).clamp(min=1e-12)


def decompose_homography(H: torch.Tensor, K: torch.Tensor) -> HomographyDecomposition:
    """Euclidean homography decomposition (Faugeras / Malis-Vargas, the
    cv::decomposeHomographyMat analog): four (R, t, n) candidates; the
    caller disambiguates by cheirality.

    The eigenvectors of Hn^T Hn come back from torch.linalg.eigh with
    signs of their own; a sign flip of any of them maps the candidate set
    onto itself (it swaps u1/u2 or negates both normals), so the four
    candidates equal the JAX package's up to order."""
    Kinv = torch.linalg.inv_ex(K)[0]
    Hn = Kinv @ H @ K
    s = torch.linalg.svdvals(Hn)
    Hn = Hn / s[1]
    w, V = torch.linalg.eigh(Hn.T @ Hn)  # ascending
    l1, l3 = w[0], w[2]
    v_small, v_mid, v_large = V[:, 0], V[:, 1], V[:, 2]
    safe = (l3 - l1).clamp(min=1e-12)
    a = torch.sqrt((1.0 - l1).clamp(min=0.0))
    b = torch.sqrt((l3 - 1.0).clamp(min=0.0))
    uu1 = (a * v_large + b * v_small) / torch.sqrt(safe)
    uu2 = (a * v_large - b * v_small) / torch.sqrt(safe)
    u1 = _unit(torch.linalg.cross(v_mid, uu1))
    u2 = _unit(torch.linalg.cross(v_mid, uu2))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=H.dtype, device=H.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=H.dtype, device=H.device)

    def candidate(u, sign):
        n = u * sign
        ref = torch.where(n[0].abs() < 0.9, ex, ey)
        e2 = _unit(torch.linalg.cross(n, ref))
        e3 = torch.linalg.cross(n, e2)
        h2 = _unit(Hn @ e2)
        h3 = _unit(Hn @ e3)
        R = project_to_rotation(
            torch.stack([h2, h3, torch.linalg.cross(h2, h3)], dim=1)
            @ torch.stack([e2, e3, torch.linalg.cross(e2, e3)], dim=1).T
        )
        return R, (Hn - R) @ n, n

    cands = [candidate(u1, 1.0), candidate(u1, -1.0), candidate(u2, 1.0), candidate(u2, -1.0)]
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    ns = torch.stack([c[2] for c in cands])
    return HomographyDecomposition(R=Rs, t=ts, n=ns, valid=torch.isfinite(Rs).all(dim=(1, 2)))


def decompose_projection_matrix(P: torch.Tensor):
    """P [3, 4] -> (K [3, 3], R [3, 3], C [3] camera centre)
    (cv::decomposeProjectionMatrix): RQ by a QR of the row-flipped M, then
    K's diagonal made positive and K[2, 2] = 1."""
    M = P[:, :3]
    rev = torch.flip(torch.eye(3, dtype=P.dtype, device=P.device), [0])
    q, r = torch.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    d = torch.sign(torch.diagonal(K))
    d = torch.where(d == 0, torch.ones_like(d), d)
    K = K * d[None, :]
    R = R * d[:, None]
    K = K / K[2, 2]
    C = -torch.linalg.inv_ex(M)[0] @ P[:, 3]
    return K, R, C


class StereoRectification(NamedTuple):
    R1: torch.Tensor
    R2: torch.Tensor
    P1: torch.Tensor
    P2: torch.Tensor
    Q: torch.Tensor


def stereo_rectify(
    K1: torch.Tensor, K2: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
    image_size: tuple[int, int],
) -> StereoRectification:
    """Bouguet rectification (cv::stereoRectify analog): each camera turns
    by half the relative rotation, then the x axis is aligned with the
    baseline."""
    h, w = image_size
    dt, dev = R.dtype, R.device
    rvec = rodrigues_inv(R)
    r_half = rodrigues(-0.5 * rvec)
    t_rect = r_half @ t
    e1 = t_rect / torch.linalg.vector_norm(t_rect).clamp(min=1e-12)
    e1 = e1 * torch.sign(torch.where(t_rect[0].abs() > 1e-9, t_rect[0], torch.ones_like(t_rect[0])))
    e2 = _unit(torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev), e1))
    e3 = torch.linalg.cross(e1, e2)
    Rrect = torch.stack([e1, e2, e3])
    R1 = Rrect @ r_half
    R2 = Rrect @ rodrigues(0.5 * rvec).T
    f = 0.5 * (K1[0, 0] + K2[1, 1])
    cx, cy = w / 2.0, h / 2.0
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    baseline = torch.linalg.vector_norm(t)
    P1 = torch.stack([torch.stack([f, zero, zero + cx, zero]), torch.stack([zero, f, zero + cy, zero]),
                      torch.stack([zero, zero, one, zero])])
    P2 = P1.clone()
    P2[0, 3] = -f * baseline
    Q = torch.stack([torch.stack([one, zero, zero, zero - cx]), torch.stack([zero, one, zero, zero - cy]),
                     torch.stack([zero, zero, zero, f]),
                     torch.stack([zero, zero, 1.0 / baseline.clamp(min=1e-12), zero])])
    return StereoRectification(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)
