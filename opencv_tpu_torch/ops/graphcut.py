"""Grid graph cuts by parallel push-relabel: min-cut binary labelling
(port of opencv_tpu/ops/graphcut.py; reference cudalegacy/src/graphcuts.cpp
and the stitching module's GraphCutSeamFinder).

Every active node pushes and relabels at once, as whole-image masked
updates: per sweep, for each direction in order, a push of min(excess,
residual) to neighbours exactly one lower; then a relabel of the nodes
that still hold excess. Terminal capacities fold into the initial
excess. The JAX package loops in a `lax.while_loop` until no node is
active (or `max_sweeps`); here the host reads the flag once per
`_CHECK_EVERY` sweeps. A sweep with no active node pushes nothing and
relabels nothing, so the sweeps run past the stop change no label, and
the sweep count (counted on the device) is the JAX loop's. The loop still
ends at exactly `max_sweeps`. The sink-reachability pass that labels the
nodes is a fixed point checked the same way. On the card, a CUDA graph
of 16 sweeps replaces their ~1 400 launches with one: a 480x640 GrabCut
(4 x 4096 sweeps) takes 4.0 s with it and 22.0 s without on an NVIDIA
H100 80GB HBM3 at 700 W (tools/ab_mincut_graph.py).

Push-relabel without global relabelling lifts a node with trapped excess
by about one height per sweep, and that excess stops only at height
H*W + 2: past ~4 000 pixels with any trapped excess, the loop ends at the
4096-sweep cap (GrabCut's demo at 70x90 does, in both packages), and
the labels come from the residual graph at the cap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_tpu_torch.core import imgproc

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))
# 8-connected extension (grabcut's diagonal N-links); opposite pairs stay
# adjacent so opp[k] = k ^ 1
_DIRS8 = _DIRS + ((-1, -1), (1, 1), (-1, 1), (1, -1))
_CHECK_EVERY = 16  # sweeps per host read of the stop flag


def _shift(x, dy, dx, fill):
    return imgproc.shift2d(x, dy, dx, fill=fill)


class MinCut(NamedTuple):
    labels: torch.Tensor  # bool [H, W], True = source side
    sweeps: int  # push-relabel sweeps until no node was active (the JAX loop's count)
    capped: bool  # stopped by max_sweeps with nodes still active
    host_reads: int  # stop flags read by the host (both loops)


class _PushRelabel:
    """The solver's state, updated in place one sweep at a time: excess,
    residuals [K, H, W], and heights and pushed amounts in buffers with a
    one-pixel border (heights n, amounts 0), so that a neighbour is a
    view. Per sweep the heights are fixed until the relabel, so the
    admissible directions (a neighbour exactly one lower, the node below
    n) are one batched comparison. Per direction, in order: amt =
    max(min(excess, res_k), 0) * admissible (a finite non-negative value
    times 1 or 0), which is the JAX function's where(active & admissible &
    (res_k > 0), min(excess, res_k), 0) up to the sign of a zero (no
    comparison sees it)."""

    def __init__(self, source_cap, sink_cap, edge_caps):
        h, w = source_cap.shape
        self.n = h * w + 2
        self.dirs = _DIRS8[:edge_caps.shape[0]]
        dev = source_cap.device
        # residual toward each direction; the reverse residual lives in the
        # neighbour's opposite slot
        self.res = edge_caps.to(torch.float32).clone()
        self.excess = source_cap.to(torch.float32) - sink_cap.to(torch.float32)
        self.hpad = torch.full((h + 2, w + 2), self.n, dtype=torch.int32, device=dev)
        self.hpad[1:-1, 1:-1] = 0
        self.apad = torch.zeros((h + 2, w + 2), dtype=torch.float32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.sweeps = torch.zeros((), dtype=torch.int32, device=dev)
        self.h, self.w = h, w

    def _nb(self, buf, dy, dx):
        """buf's interior shifted: view[p] = buf[p + (dy, dx)]."""
        return buf[1 + dy: 1 + dy + self.h, 1 + dx: 1 + dx + self.w]

    def sweep(self):
        height = self.hpad[1:-1, 1:-1]
        excess, res, n = self.excess, self.res, self.n
        nbs = torch.stack([self._nb(self.hpad, dy, dx) for dy, dx in self.dirs])
        below = height < n
        adm = ((nbs == height - 1) & below).to(torch.float32)
        self.sweeps += (~self.done).to(torch.int32)
        for k, (dy, dx) in enumerate(self.dirs):
            amt = torch.minimum(excess, res[k]).clamp(min=0.0) * adm[k]
            excess -= amt
            res[k] -= amt
            # flow pushed by p lands at p + (dy, dx)
            self.apad[1:-1, 1:-1] = amt
            arrived = self._nb(self.apad, -dy, -dx)
            excess += arrived
            res[k ^ 1] += arrived
        # relabel: nodes with excess and no admissible edge rise to one
        # above their lowest neighbour across a residual edge
        min_h = torch.where(res > 0, nbs + 1, n).amin(0)
        need = (excess > 0) & below
        height.copy_(torch.where(need, torch.maximum(height, min_h), height))
        self.done.copy_(~((excess > 0) & (height < n)).any())

    def labels(self) -> tuple[torch.Tensor, int]:
        """Nodes that reach the sink through residual edges are the sink
        side; reachability spreads from the nodes still owing sink flow.
        Returns (labels, host reads)."""
        h, w = self.h, self.w
        rpad = torch.zeros((h + 2, w + 2), dtype=torch.bool, device=self.res.device)
        rpad[1:-1, 1:-1] = self.excess < 0
        open_ = self.res > 0
        reads = 0
        while True:
            for _ in range(_CHECK_EVERY):
                reach = rpad[1:-1, 1:-1]
                nbs = torch.stack([self._nb(rpad, dy, dx) for dy, dx in self.dirs])
                new = reach | (nbs & open_).any(0)
                changed = (new != reach).any()
                reach.copy_(new)
            reads += 1
            if not bool(changed):
                return ~rpad[1:-1, 1:-1], reads


def _sweeps_graph(pr: _PushRelabel, count: int):
    """A CUDA graph of `count` sweeps of `pr` (captured, not run: the
    state is not touched)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            pr.sweep()
    return graph


def min_cut_grid_stats(source_cap: torch.Tensor, sink_cap: torch.Tensor, edge_caps: torch.Tensor,
                       max_sweeps: int = 4096) -> MinCut:
    """`min_cut_grid` with its sweep count, whether it hit the cap, and
    its host reads. On the card the sweeps after the first `_CHECK_EVERY`
    replay one CUDA graph of `_CHECK_EVERY` sweeps (the same kernels as
    the eager sweeps, launched at once)."""
    assert edge_caps.shape[0] in (4, 8), edge_caps.shape
    pr = _PushRelabel(source_cap, sink_cap, edge_caps)
    graph = None
    run = reads = 0
    while run < max_sweeps:
        chunk = min(_CHECK_EVERY, max_sweeps - run)
        if graph is not None and chunk == _CHECK_EVERY:
            graph.replay()
        else:
            for _ in range(chunk):
                pr.sweep()
        run += chunk
        reads += 1
        if bool(pr.done):
            break
        if graph is None and pr.excess.is_cuda:
            graph = _sweeps_graph(pr, _CHECK_EVERY)
    labels, label_reads = pr.labels()
    return MinCut(labels, int(pr.sweeps), not bool(pr.done), reads + label_reads)


def min_cut_grid(source_cap: torch.Tensor, sink_cap: torch.Tensor, edge_caps: torch.Tensor,
                 max_sweeps: int = 4096) -> torch.Tensor:
    """Binary min-cut labels (True = source side). source_cap/sink_cap:
    [H, W] >= 0 terminal capacities; edge_caps: [K, H, W] with K = 4 (up,
    down, left, right) or 8 (+ the _DIRS8 diagonals), the capacity toward
    each neighbour (symmetric input expected)."""
    return min_cut_grid_stats(source_cap, sink_cap, edge_caps, max_sweeps).labels


def seam_find_graphcut(img0: torch.Tensor, m0: torch.Tensor, img1: torch.Tensor, m1: torch.Tensor,
                       smooth_weight: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph-cut seam between two overlapping warped images
    (GraphCutSeamFinder COST_COLOR analog): pixels of one image only are
    hard-assigned; in the overlap the pairwise cost is the colour
    difference across the cut."""
    overlap = m0 & m1
    big = 1e6
    src = torch.where(m0 & ~m1, big, 0.0)
    snk = torch.where(m1 & ~m0, big, 0.0)
    diff = (img0 - img1).abs()
    edges = []
    for dy, dx in _DIRS:
        nb = _shift(diff, dy, dx, 0.0)
        cap = smooth_weight * 0.5 * (diff + nb) + 1e-3
        both = overlap & _shift(overlap, dy, dx, False)
        edges.append(torch.where(both, cap, big))
    labels = min_cut_grid(src, snk, torch.stack(edges))
    return m0 & (labels | ~m1), m1 & (~labels | ~m0)
