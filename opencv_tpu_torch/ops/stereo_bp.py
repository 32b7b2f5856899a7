"""Stereo belief propagation (BP) and constant-space BP (CSBP) (port of
opencv_tpu/ops/stereo_bp.py; reference cudastereo/src/stereobp.cpp,
stereocsbp.cpp).

Hierarchical min-sum loopy BP on a checkerboard schedule: truncated-linear
data and smoothness terms, messages as one [4, H, W, D] tensor (incoming
from up, down, left, right), the truncated-linear distance transform over
D by a log-depth doubling tree (`_truncated_linear_dt`, stereo_bp.py:51-68,
a host loop with static steps), costs 2x2 sum-pooled up the pyramid and
messages repeated down it. CSBP keeps the `nr_plane` lowest-cost
disparities per pixel and evaluates the smoothness term [P, P] against
each neighbour's planes.

The JAX function picks CSBP's planes with `lax.top_k(-cost, nr_plane)`
(stereo_bp.py:196), which takes the lower disparity first on ties;
`torch.topk` promises no order, so a stable ascending sort takes the
planes here. Messages are normalised by their mean over D, a sum whose
order is the library's: BP agrees with the JAX function on most pixels,
not all (tests/test_torch_stereo.py).
"""

from __future__ import annotations

import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops.stereo import shifted_planes

_BIG = 1e9


def _data_cost(left: torch.Tensor, right: torch.Tensor, num_disparities: int,
               max_data_term: float, data_weight: float) -> torch.Tensor:
    """Truncated linear data cost [H, W, D] (stereobp.cu data_cost)."""
    w = left.shape[1]
    planes = shifted_planes(right, range(num_disparities))  # [D, H, W]
    c = torch.clamp(torch.abs(left[None] - planes), max=max_data_term)
    ds = torch.arange(num_disparities, device=left.device)[:, None, None]
    xx = torch.arange(w, device=left.device)[None, None, :]
    c = torch.where(xx >= ds, c, max_data_term)
    return (data_weight * c).permute(1, 2, 0).contiguous()


def _truncated_linear_dt(m: torch.Tensor, jump: float, max_disc: float) -> torch.Tensor:
    """out(d) = min_d' m(d') + min(|d - d'| jump, max_disc) over the last
    axis, by a log-depth doubling tree."""
    d = m.shape[-1]
    out = m
    step = 1
    while step < d:
        pad = torch.full_like(out[..., :step], _BIG)
        lo = torch.cat([pad, out[..., :-step]], -1)
        hi = torch.cat([out[..., step:], pad], -1)
        out = torch.minimum(out, torch.minimum(lo, hi) + step * jump)
        step *= 2
    return torch.minimum(out, m.amin(dim=-1, keepdim=True) + max_disc)


def _shift_msg(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """shift2d of an [H, W, D] message over its first two axes."""
    return imgproc.shift2d(m.permute(2, 0, 1), dy, dx, fill=0.0).permute(1, 2, 0)


def _sum4(msgs: torch.Tensor) -> torch.Tensor:
    return msgs[0] + msgs[1] + msgs[2] + msgs[3]


def _norm(m: torch.Tensor) -> torch.Tensor:
    """Min-sum messages are shift-invariant; keep f32 bounded."""
    return m - m.mean(dim=-1, keepdim=True)


def _message_pass(msgs: torch.Tensor, cost: torch.Tensor, mask: torch.Tensor, jump: float,
                  max_disc: float) -> torch.Tensor:
    """One checkerboard half: the message from p toward its neighbour q is
    DT(cost_p + p's incoming except q's), landing in q's slot for the
    opposite direction."""
    total = cost + _sum4(msgs)
    out_up = _truncated_linear_dt(total - msgs[1], jump, max_disc)  # to y-1
    out_dn = _truncated_linear_dt(total - msgs[0], jump, max_disc)  # to y+1
    out_lf = _truncated_linear_dt(total - msgs[3], jump, max_disc)  # to x-1
    out_rt = _truncated_linear_dt(total - msgs[2], jump, max_disc)  # to x+1
    new = torch.stack([
        _shift_msg(_norm(out_dn), 1, 0),  # incoming from up = the up-neighbour's "down"
        _shift_msg(_norm(out_up), -1, 0),
        _shift_msg(_norm(out_rt), 0, 1),
        _shift_msg(_norm(out_lf), 0, -1),
    ])
    return torch.where(mask[None, :, :, None], new, msgs)


def _checkerboard(h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return ((yy + xx) % 2) == 0


def stereo_bp(
    left,
    right,
    num_disparities: int = 64,
    n_iters: int = 5,
    n_levels: int = 4,
    max_data_term: float = 10.0,
    data_weight: float = 0.07,
    max_disc_term: float = 1.7,
    disc_single_jump: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Hierarchical loopy BP disparity f32 [H, W]
    (cuda::StereoBeliefPropagation analog). Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev).to(torch.float32)
    right = torch.as_tensor(right, device=dev).to(torch.float32)
    cost0 = _data_cost(left, right, num_disparities, max_data_term, data_weight)
    costs = [cost0]
    for _ in range(1, n_levels):
        c = costs[-1]
        ch2, cw2 = (c.shape[0] // 2) * 2, (c.shape[1] // 2) * 2
        c = c[:ch2, :cw2].reshape(ch2 // 2, 2, cw2 // 2, 2, -1).sum(dim=(1, 3))
        costs.append(c)
    msgs = torch.zeros((4,) + costs[-1].shape, dtype=torch.float32, device=dev)
    for lvl in range(n_levels - 1, -1, -1):
        cost = costs[lvl]
        cb = _checkerboard(cost.shape[0], cost.shape[1], dev)
        for _ in range(n_iters):
            msgs = _message_pass(msgs, cost, cb, disc_single_jump, max_disc_term)
            msgs = _message_pass(msgs, cost, ~cb, disc_single_jump, max_disc_term)
        if lvl > 0:
            nh, nw = costs[lvl - 1].shape[:2]
            msgs = msgs.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :nh, :nw]
            pad_h, pad_w = nh - msgs.shape[1], nw - msgs.shape[2]
            if pad_h > 0 or pad_w > 0:  # odd sizes: repeat the edge
                msgs = torch.cat([msgs, msgs[:, -1:].expand(-1, pad_h, -1, -1)], 1)
                msgs = torch.cat([msgs, msgs[:, :, -1:].expand(-1, -1, pad_w, -1)], 2)
    belief = cost0 + _sum4(msgs)
    return torch.argmin(belief, dim=-1).to(torch.float32)


def csbp_planes(cost: torch.Tensor, nr_plane: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(costs, disparities) of the nr_plane lowest-cost disparities per
    pixel, lower disparity first on ties (`lax.top_k(-cost)`'s order)."""
    vals, idx = torch.sort(cost, dim=-1, stable=True)
    return vals[..., :nr_plane], idx[..., :nr_plane]


def stereo_csbp(
    left,
    right,
    num_disparities: int = 64,
    nr_plane: int = 8,
    n_iters: int = 6,
    max_data_term: float = 10.0,
    data_weight: float = 0.07,
    max_disc_term: float = 1.7,
    disc_single_jump: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Constant-space BP disparity f32 [H, W]
    (cuda::StereoConstantSpaceBP analog): BP over each pixel's nr_plane
    best data-cost disparities. Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    left = torch.as_tensor(left, device=dev).to(torch.float32)
    right = torch.as_tensor(right, device=dev).to(torch.float32)
    h, w = left.shape
    cost = _data_cost(left, right, num_disparities, max_data_term, data_weight)
    sel_cost, planes = csbp_planes(cost, nr_plane)
    planes_f = planes.to(torch.float32)
    msgs = torch.zeros((4, h, w, nr_plane), dtype=torch.float32, device=dev)
    cb = _checkerboard(h, w, dev)

    def pass_dir(total, msgs_from, dy, dx):
        """Outgoing message toward the (dy, dx) neighbour on that
        neighbour's planes, shifted into its incoming slot."""
        src = total - msgs_from
        npl = _shift_msg(planes_f, -dy, -dx)  # the planes of the pixel at (+dy, +dx)
        vdiff = torch.abs(npl[..., None, :] - planes_f[..., :, None])  # [H, W, P, P']
        smooth = torch.clamp(vdiff * disc_single_jump, max=max_disc_term)
        m = (src[..., :, None] + smooth).amin(dim=-2)
        return _shift_msg(_norm(m), dy, dx)

    def half(msgs, mask):
        total = sel_cost + _sum4(msgs)
        new = torch.stack([pass_dir(total, msgs[1], 1, 0), pass_dir(total, msgs[0], -1, 0),
                           pass_dir(total, msgs[2], 0, 1), pass_dir(total, msgs[3], 0, -1)])
        return torch.where(mask[None, :, :, None], new, msgs)

    for _ in range(n_iters):
        msgs = half(msgs, cb)
        msgs = half(msgs, ~cb)
    best = torch.argmin(sel_cost + _sum4(msgs), dim=-1)
    return torch.gather(planes_f, -1, best[..., None])[..., 0]
