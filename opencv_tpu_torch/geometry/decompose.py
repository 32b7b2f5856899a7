"""Homography -> motion candidates (the engine's subset of
opencv_tpu/geometry/decompose.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.geometry.rotation import project_to_rotation


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
