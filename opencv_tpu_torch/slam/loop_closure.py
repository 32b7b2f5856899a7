"""Loop-closure detection and pose-graph correction (port of
opencv_tpu/slam/loop_closure.py): retrieval by ratio-tested descriptor
votes over the keyframe database and pose-graph relaxation over
keyframes. (The engine verifies a candidate with its own match + PnP
stage, `slam/vo.py`.)

These helpers take and return numpy arrays; `device=None` runs their
tensor work on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import matching
from opencv_tpu_torch.optim import pose_graph


class LoopCandidate(NamedTuple):
    kf_index: int
    n_votes: int


def _desc(x: np.ndarray, dev) -> torch.Tensor:
    """uint32 descriptor words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)


def retrieve_candidates(
    query_desc: np.ndarray, query_valid: np.ndarray,
    db_desc: np.ndarray, db_valid: np.ndarray,  # [K, N, 8], [K, N]
    exclude_recent: int = 5, min_votes: int = 30, max_candidates: int = 3,
    ratio: float = 0.8, device=None,
) -> list[LoopCandidate]:
    """Vote keyframes by ratio-tested descriptor matches."""
    dev = resolve_device(device)
    k, n, _ = db_desc.shape
    if k <= exclude_recent:
        return []
    flat_desc = db_desc[: k - exclude_recent].reshape(-1, 8)
    flat_valid = db_valid[: k - exclude_recent].reshape(-1)
    m = matching.knn_match_auto(
        _desc(query_desc, dev), _desc(flat_desc, dev),
        query_valid=torch.as_tensor(query_valid, device=dev),
        train_valid=torch.as_tensor(flat_valid, device=dev),
        config=MatchConfig(ratio=ratio, cross_check=False),
    )
    v = m.valid.cpu().numpy()
    owner = m.train_idx.cpu().numpy()[v] // n
    votes = np.bincount(owner, minlength=k - exclude_recent)
    order = np.argsort(-votes)
    return [LoopCandidate(int(kf), int(votes[kf])) for kf in order[:max_candidates]
            if votes[kf] >= min_votes]


def correct_poses(
    kf_rvecs: np.ndarray, kf_tvecs: np.ndarray, loop_i: int, loop_j: int,
    loop_rel: tuple[np.ndarray, np.ndarray], loop_weight: float = 10.0,
    iters: int = 20, device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pose graph of consecutive odometry edges (from the current
    estimates) plus one trusted loop edge, relaxed with keyframe 0 fixed.
    (The JAX package pads nodes and edges to buckets of 16 to keep its
    compiled program shape; padded nodes are fixed and padded edges carry
    weight 0, so the port solves the unpadded graph.)"""
    dev = resolve_device(device)
    k = kf_rvecs.shape[0]
    rv = torch.as_tensor(kf_rvecs, dtype=torch.float32, device=dev)
    tv = torch.as_tensor(kf_tvecs, dtype=torch.float32, device=dev)
    rr, tt = pose_graph.relative_pose(rv[:-1], tv[:-1], rv[1:], tv[1:])
    loop = torch.as_tensor(
        np.concatenate([np.asarray(loop_rel[0]), np.asarray(loop_rel[1])]),
        dtype=torch.float32, device=dev,
    )
    meas = torch.cat([torch.cat([rr, tt], dim=1), loop[None]])
    ei = torch.tensor(list(range(k - 1)) + [loop_i], device=dev)
    ej = torch.tensor(list(range(1, k)) + [loop_j], device=dev)
    wts = torch.tensor([1.0] * (k - 1) + [loop_weight], dtype=torch.float32, device=dev)
    fixed = torch.zeros(k, dtype=torch.bool, device=dev)
    fixed[0] = True
    g = pose_graph.PoseGraph(rvec=rv, tvec=tv, edge_i=ei, edge_j=ej, edge_meas=meas,
                             edge_weight=wts, fixed=fixed)
    opt, _ = pose_graph.optimize(g, iters=iters)
    return opt.rvec.cpu().numpy(), opt.tvec.cpu().numpy()


def relative_from_world_poses(rvec_i, tvec_i, rvec_j, tvec_j, device=None):
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    rr, tt = pose_graph.relative_pose(f(rvec_i), f(tvec_i), f(rvec_j), f(tvec_j))
    return rr.cpu().numpy(), tt.cpu().numpy()
