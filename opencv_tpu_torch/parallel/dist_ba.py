"""Distributed bundle adjustment, observation-sharded with a matrix-free
Schur-CG (port of opencv_tpu/parallel/dist_ba.py).

Every rank calls these functions with the same full problem and keeps
its own block of observations (`mesh.shard_leading(mesh, axes)`): the
contract of the JAX package's `shard_map`. Nothing observation-sized
crosses between ranks:

  * per LM step, U [C,D,D], V [P,3,3], bc [C,D], bp [P,3] and the new
    cost are all-reduced over the ranks of `axes` (JAX's psum);
  * the per-observation blocks A = Jc^T Jp stay on their rank;
  * each CG iteration all-reduces one [P,3] and one [C,D] partial sum
    (optim/ba.py `schur_cg_solve(group=...)`).

Every rank then holds the same bits of every reduced tensor, so all take
the same LM decision on the device without a host read. `axes` is one
mesh axis or the (host, chip) pair of parallel/multihost.py, which
reduces over the whole mesh. Observations are padded to a multiple of
the ranks (invalid rows add zeros).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.optim import ba
from opencv_tpu_torch.parallel.mesh import DATA_AXIS, axes_group, axis_size, shard_leading

Axes = str | tuple[str, ...]


def _local(p: ba.BAProblem, mesh: DeviceMesh, axes: Axes) -> ba.BAProblem:
    """The problem with this rank's block of observations (views)."""
    rows = shard_leading(mesh, axes).block(p.obs_cam.shape[0])
    return p._replace(obs_cam=p.obs_cam[rows], obs_pt=p.obs_pt[rows],
                      obs_uv=p.obs_uv[rows], obs_valid=p.obs_valid[rows])


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def _assemble(local: ba.BAProblem, huber_delta: float | None, group) -> ba.NormalEqs:
    eqs = ba.normal_equations(local, huber_delta)
    for t in (eqs.U, eqs.V, eqs.bc, eqs.bp):
        dist.all_reduce(t, group=group)
    return eqs


@no_tf32()
def sharded_normal_equations(p: ba.BAProblem, mesh: DeviceMesh, huber_delta: float | None = None,
                             axes: Axes = DATA_AXIS) -> ba.NormalEqs:
    """Normal equations with U, V, bc, bp summed over the ranks of `axes`
    (alike on every rank) and A this rank's rows only (never gathered)."""
    return _assemble(_local(p, mesh, axes), huber_delta, axes_group(mesh, axes))


@no_tf32()
def ba_step_sharded(state: ba.BAStepState, mesh: DeviceMesh, huber_delta: float | None = None,
                    cg_iters: int = 60, axes: Axes = DATA_AXIS) -> ba.BAStepState:
    """One LM step with distributed assembly and distributed Schur-CG
    (drop-in for ba.ba_step's CG solver)."""
    p = state.problem
    group = axes_group(mesh, axes)
    local = _local(p, mesh, axes)
    eqs = _assemble(local, huber_delta, group)
    dc, dp = ba.schur_cg_solve(eqs, local.obs_cam, local.obs_pt, state.lam, p.fixed_cams,
                               cg_iters, group=group)
    cand = ba.candidate(p, dc, dp)
    c_new = _summed(ba.cost(_local(cand, mesh, axes)), group)
    accept = (c_new < state.cost) & torch.isfinite(c_new)
    lam = torch.where(accept, state.lam / 3.0, state.lam * 4.0).clamp(1e-10, 1e10)
    return ba.BAStepState(problem=ba.merge(accept, p, cand), lam=lam, cost=torch.where(accept, c_new, state.cost),
                          n_accepted=state.n_accepted + accept.to(torch.int32))


def bundle_adjust_sharded(p: ba.BAProblem, mesh: DeviceMesh, iters: int = 20, lambda0: float = 1e-4,
                          huber_delta: float | None = None, cg_iters: int = 60,
                          axes: Axes = DATA_AXIS) -> tuple[ba.BAProblem, torch.Tensor]:
    """Distributed bundle_adjust: `iters` LM steps. The observation count
    must divide by the number of ranks over `axes` (pad with
    obs_valid=False rows). Returns (optimized problem, final cost), alike
    on every rank."""
    n_ranks = axis_size(mesh, axes)
    n_obs = p.obs_cam.shape[0]
    if n_obs % n_ranks:
        raise ValueError(f"pad observations ({n_obs}) to a multiple of mesh size ({n_ranks})")
    dev = p.points.device
    with no_tf32():
        cost0 = _summed(ba.cost(_local(p, mesh, axes)), axes_group(mesh, axes))
    state = ba.BAStepState(
        problem=p, lam=torch.tensor(lambda0, dtype=torch.float32, device=dev), cost=cost0,
        n_accepted=torch.tensor(0, dtype=torch.int32, device=dev),
    )
    for _ in range(iters):
        state = ba_step_sharded(state, mesh, huber_delta, cg_iters, axes)
    return state.problem, state.cost
