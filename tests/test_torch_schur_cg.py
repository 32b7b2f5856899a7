"""The point-major layout of the Schur-CG kernel (ops/cuda/schur_cg.py) on
the CPU: the sort, the (camera, point) pairs, the point offsets, the chunk
schedule and the camera-major order against numpy, on sorted, shuffled and
empty-point inputs; a model of the kernel's order of work
(csrc/schur_cg.cu: blocks over chunks, a chunk in stage memory or walked
point by point, each point's sum over its observations in order) held to
the plain version in float64, so that the schedule covers every
observation and every point once; and the CPU route of the CG.

Imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch

from opencv_tpu_torch.ops.cuda import schur_cg

TILE = 512  # observations a stage of the kernel holds (csrc/schur_cg.cu)


def _observations(kind, n_cams=40, n_pts=700, seed=0):
    """obs_cam, obs_pt (numpy i64): tracks of 1-12 views, one of 900
    ("long": a chunk above a stage), points without observations
    ("empty"), point by point ("sorted") or shuffled."""
    rng = np.random.default_rng(seed)
    pts = np.arange(n_pts)
    if kind == "empty":
        pts = np.sort(rng.permutation(n_pts)[: n_pts // 2])
        pts = pts[pts != n_pts - 1]  # the last point too
    lengths = rng.integers(1, 13, len(pts))
    if kind == "long":
        lengths[len(pts) // 3] = 900
    obs_pt = np.repeat(pts, lengths)
    obs_cam = rng.integers(0, n_cams - 3, len(obs_pt))  # the last three cameras see nothing
    if kind != "sorted":
        order = rng.permutation(len(obs_pt))
        obs_pt, obs_cam = obs_pt[order], obs_cam[order]
    return obs_cam, obs_pt, n_cams, n_pts


KINDS = ["sorted", "shuffled", "empty", "long"]


@pytest.mark.parametrize("kind", KINDS)
def test_point_layout_against_numpy(kind):
    obs_cam, obs_pt, C, P = _observations(kind)
    O = len(obs_pt)
    lay = schur_cg.point_layout(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt), C, P, camera_runs=True,
                                ordered=True)
    perm = np.argsort(obs_pt, kind="stable")
    assert np.array_equal(lay.perm.numpy(), perm)
    assert lay.idx.dtype == torch.int32 and lay.idx.shape == (O + 2, 2)
    assert np.array_equal(lay.idx[:O, 0].numpy(), obs_cam[perm])
    assert np.array_equal(lay.idx[:O, 1].numpy(), obs_pt[perm])
    off = np.searchsorted(obs_pt[perm], np.arange(P + 1))
    assert np.array_equal(lay.off.numpy(), off)
    K = -(-O // schur_cg.STRIDE)
    # chunk k: the points whose observations begin in [k STRIDE, (k+1) STRIDE)
    begins = off[:P]
    want_pt = [int(np.sum(begins < k * schur_cg.STRIDE)) for k in range(K)] + [P]
    assert np.array_equal(lay.chunk_pt.numpy(), want_pt)
    assert np.array_equal(lay.chunk_obs.numpy(), off[want_pt])
    for k in range(K):
        q0, q1 = want_pt[k], want_pt[k + 1]
        assert all(k * schur_cg.STRIDE <= b < (k + 1) * schur_cg.STRIDE for b in begins[q0:q1] if k < K - 1)
    # the kernel's blocks share the chunks out in order, each chunk once
    for blocks in (1, 3, min(132, K)):
        got = [k for b in range(blocks) for k in range(b * K // blocks, (b + 1) * K // blocks)]
        assert got == list(range(K))
    # each chunk's observations in camera order, chunk-local, point-major within a camera
    cams = obs_cam[perm]
    chunk_obs = lay.chunk_obs.numpy()
    cs = lay.cs.numpy().view(np.uint16)
    for k in range(K):
        s, e = chunk_obs[k], chunk_obs[k + 1]
        order = np.argsort(cams[s:e], kind="stable")
        if e - s <= TILE:
            assert np.array_equal(cs[s:e] & 0x7FFF, order)
        first = np.r_[True, cams[s:e][order][1:] != cams[s:e][order][:-1]]
        assert np.array_equal(cs[s:e] >> 15, first[: e - s])
    assert lay.cs.dtype == torch.int16 and lay.cs.shape == (O,)
    # camera-major order of the point-major positions, point-major within a camera
    cperm = np.argsort(cams, kind="stable")
    assert np.array_equal(lay.cidx.numpy(), cperm)
    assert np.array_equal(lay.coff.numpy(), np.searchsorted(cams[cperm], np.arange(C + 1)))
    plain = schur_cg.point_layout(torch.from_numpy(obs_cam), torch.from_numpy(obs_pt), C, P)
    assert plain.cs is None and plain.cidx is None and plain.coff is None


def test_point_layout_without_observations():
    none = torch.zeros(0, dtype=torch.int64)
    lay = schur_cg.point_layout(none, none, 5, 9, camera_runs=True, ordered=True)
    assert lay.off.tolist() == [0] * 10 and lay.chunk_pt.tolist() == [0, 9] and lay.chunk_obs.tolist() == [0, 0]
    assert lay.idx.shape == (2, 2) and lay.coff.tolist() == [0] * 6 and lay.cs.shape == (0,)


def _kernel_model(lay, A, vinv, x, pin, mode, C, P, blocks):
    """The kernel's order of work in float64: blocks over chunks; a chunk
    of at most TILE observations sums each point's t_o in observation
    order, a larger one walks its points; W^T x (g), V^-1 (bp - g) (back),
    V^-1 bp (back without x: "vinv"), V^-1 g given (hz) or x -> V^-1 g
    (full), h by block partials summed in block order. Asserts that each
    chunk holds whole points."""
    off = lay.off.numpy()
    cams = lay.idx[:, 0].numpy()
    chunk_obs, chunk_pt = lay.chunk_obs.numpy(), lay.chunk_pt.numpy()
    K = len(chunk_obs) - 1
    pout = np.full((P, 3), np.nan)
    parts = np.zeros((blocks, C, 6))
    for b in range(blocks):
        for k in range(b * K // blocks, (b + 1) * K // blocks):
            s, e, q0, q1 = chunk_obs[k], chunk_obs[k + 1], chunk_pt[k], chunk_pt[k + 1]
            assert off[q0] == s and off[q1] == e
            t = np.einsum("oij,oi->oj", A[s:e], x[cams[s:e]]) if mode not in ("hz", "vinv") else None
            for q in range(q0, q1):
                lo, hi = off[q], off[q + 1]
                g = t[lo - s:hi - s].sum(0) if t is not None else 0.0
                g = {"hz": pin[q], "back": pin[q] - g, "vinv": pin[q] - g}.get(mode, g)
                z = g if mode == "g" else vinv[q] @ g
                if mode in ("g", "back", "vinv"):
                    assert np.isnan(pout[q]).all()
                    pout[q] = z
                else:
                    np.add.at(parts[b], cams[lo:hi], np.einsum("oij,j->oi", A[lo:hi], z))
    return pout if mode in ("g", "back", "vinv") else parts.sum(0)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_order_of_work_equals_plain(kind):
    obs_cam, obs_pt, C, P = _observations(kind, seed=1)
    rng = np.random.default_rng(2)
    O = len(obs_pt)
    A = rng.normal(size=(O, 6, 3))
    vinv = rng.normal(size=(P, 3, 3))
    x, bp = rng.normal(size=(C, 6)), rng.normal(size=(P, 3))
    cam_t, pt_t = torch.from_numpy(obs_cam), torch.from_numpy(obs_pt)
    lay = schur_cg.point_layout(cam_t, pt_t, C, P)
    A_pm = A[lay.perm.numpy()]
    assert any(e - s > TILE for s, e in zip(lay.chunk_obs[:-1].tolist(), lay.chunk_obs[1:].tolist())) == (kind == "long")
    At, vt = torch.from_numpy(A), torch.from_numpy(vinv)

    def plain_wt_x(v):
        return schur_cg.wt_x_plain(At, cam_t, pt_t, torch.from_numpy(v), P).numpy()

    def plain_w_vinv(g):
        z = torch.einsum("pij,pj->pi", vt, torch.from_numpy(g))
        return schur_cg.w_z_plain(At, cam_t, pt_t, z, C).numpy()

    want = {"g": plain_wt_x(x), "back": np.einsum("pij,pj->pi", vinv, bp - plain_wt_x(x)),
            "vinv": np.einsum("pij,pj->pi", vinv, bp), "hz": plain_w_vinv(bp), "full": plain_w_vinv(plain_wt_x(x))}
    for mode, w in want.items():
        for blocks in (1, 5):
            got = _kernel_model(lay, A_pm, vinv, x, bp, mode, C, P, blocks)
            np.testing.assert_allclose(got, w, rtol=1e-10, atol=1e-10, err_msg=f"{mode}, {blocks} blocks")


def test_products_refuse_cpu_tensors():
    """SchurProducts is the kernel's: CPU tensors are refused there, and
    schur_cg_solve takes the plain version for them."""
    obs_cam, obs_pt, C, P = _observations("shuffled", seed=3)
    g = torch.Generator().manual_seed(0)
    A = torch.randn((len(obs_pt), 6, 3), generator=g)
    vinv = torch.randn((P, 3, 3), generator=g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        schur_cg.SchurProducts(A, torch.from_numpy(obs_cam), torch.from_numpy(obs_pt), vinv, torch.ones((C, 1)), C, P)
