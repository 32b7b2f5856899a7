"""The normal-equations kernel (K7, csrc/normal_eq.cu, wrapper
ops/cuda/normal_eq.py) on the CPU: the wrapper refuses CPU tensors and
names the plain version; the route its plan takes at the benchmark
cells' camera counts and widths, by the kernel's shared-memory arithmetic;
the camera table's layout (`camera_table`, the plain version of the
kernel's table); and a float64 model of the kernel's work (its
formulas, reading the table as the kernel does, and its partition of the
observations over blocks, camera ranges, tiles and each warp's runs of
equal points) held to the plain version, so that every observation is
counted once and each term has `_blocks`' mathematics.

Imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch

from opencv_tpu_torch.geometry.rotation import hat, rodrigues, rodrigues_jacobian
from opencv_tpu_torch.ops.cuda import normal_eq
from opencv_tpu_torch.optim import ba

H100_OPTIN = 232_448  # bytes of shared memory a block may opt into on an H100 (227 KB)


def _problem(width=6, n_cams=9, n_pts=120, seed=0, shuffled=False, masked=False, long_track=0):
    """A small float64 problem: tracks of 2-6 consecutive cameras, one
    point seen `long_track` more times by the first camera (a hot camera),
    point by point or shuffled, a fifth of the observations masked, and
    the last camera and point seen by none."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 7, n_pts - 1)
    obs_pt = np.repeat(np.arange(n_pts - 1), lengths)
    first = rng.integers(0, n_cams - 6, n_pts - 1)
    obs_cam = np.repeat(first, lengths) + np.concatenate([np.arange(n) for n in lengths])
    if long_track:
        obs_pt = np.concatenate([obs_pt, np.full(long_track, n_pts // 2)])
        obs_cam = np.concatenate([obs_cam, np.zeros(long_track, dtype=np.int64)])
    if shuffled:
        order = rng.permutation(len(obs_pt))
        obs_pt, obs_cam = obs_pt[order], obs_cam[order]
    O = len(obs_pt)
    pts = np.concatenate([rng.uniform(-2, 2, (n_pts, 2)), rng.uniform(4, 9, (n_pts, 1))], 1)
    f64 = torch.float64
    fields = dict(
        cam_rvec=torch.from_numpy(rng.normal(0, 0.1, (n_cams, 3))),
        cam_tvec=torch.from_numpy(rng.normal(0, 0.3, (n_cams, 3))),
        points=torch.from_numpy(pts),
        obs_cam=torch.from_numpy(obs_cam), obs_pt=torch.from_numpy(obs_pt),
        obs_uv=torch.from_numpy(rng.normal(0, 0.3, (O, 2))),
        obs_valid=torch.from_numpy(rng.random(O) > (0.2 if masked else 0.0)),
        fixed_cams=torch.zeros(n_cams, dtype=torch.bool),
    )
    if width == 9:
        intr = np.stack([rng.uniform(700, 1100, n_cams), rng.uniform(-0.15, 0.05, n_cams),
                         rng.uniform(-0.05, 0.05, n_cams)], 1)
        fields["cam_intr"] = torch.from_numpy(intr)
        fields["cam_tvec"] = fields["cam_tvec"] + torch.tensor([0.0, 0.0, -12.0], dtype=f64)
        fields["obs_uv"] = fields["obs_uv"] * 300.0
    return ba.BAProblem(**fields)


def _table(p):
    return normal_eq.camera_table(rodrigues(p.cam_rvec), rodrigues_jacobian(p.cam_rvec), p.cam_tvec, p.cam_intr)


def _model_blocks(p, table, width, huber):
    """r, Jc, Jp as csrc/normal_eq.cu `observe` forms them, in float64:
    the camera's row of the table read at the kernel's offsets."""
    tb = table[p.obs_cam]
    R = tb[:, :9].reshape(-1, 3, 3)
    t, dR = tb[:, 9:12], tb[:, 12:39].reshape(-1, 3, 3, 3)
    X = p.points[p.obs_pt]
    pc = torch.einsum("oij,oj->oi", R, X) + t
    guard = pc[:, 2].abs() < 1e-9
    zs = torch.where(guard, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
    u, v = pc[:, 0] / zs, pc[:, 1] / zs
    iz = 1.0 / zs
    zero = torch.zeros_like(u)
    du0, du1 = torch.where(guard, zero, -u / zs), torch.where(guard, zero, -v / zs)
    dP = torch.stack([torch.stack([iz, zero, du0], -1), torch.stack([zero, iz, du1], -1)], 1)
    cols = []
    if width == 6:
        res = torch.stack([u, v], 1) - p.obs_uv
    else:
        f, k1, k2 = tb[:, 39], tb[:, 40], tb[:, 41]
        p0, p1 = -u, -v
        s = p0 * p0 + p1 * p1
        d = 1.0 + s * (k1 + k2 * s)
        res = torch.stack([f * d * p0, f * d * p1], 1) - p.obs_uv
        e = 2.0 * (k1 + 2.0 * k2 * s)
        m00, m01, m11 = f * (d + e * p0 * p0), f * (e * p0 * p1), f * (d + e * p1 * p1)
        dP = -torch.stack([torch.stack([m00 * iz, m01 * iz, m00 * du0 + m01 * du1], -1),
                           torch.stack([m01 * iz, m11 * iz, m01 * du0 + m11 * du1], -1)], 1)
        fs = f * s
        cols = [torch.stack([d * p0, d * p1], 1), torch.stack([fs * p0, fs * p1], 1),
                torch.stack([fs * s * p0, fs * s * p1], 1)]
    dr = torch.einsum("oijk,oj->oik", dR, X)
    Jc = torch.cat([dP @ dr, dP] + [c[:, :, None] for c in cols], -1)
    Jp = dP @ R
    w = p.obs_valid.to(res.dtype)
    if huber is not None:
        nrm = torch.sqrt((res * res).sum(-1) + 1e-18)
        w = w * torch.sqrt(torch.clamp(huber / nrm, max=1.0))
    return res * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]


def _model_sums(p, r, Jc, Jp, nq, ranges):
    """U, V, bc, bp, A by the kernel's partition: block (q, range) takes
    the observations [q per, (q+1) per) of its camera range, a tile of
    whole warps at a time; each warp's runs of equal points are summed,
    then added once."""
    C, P, O, D = p.cam_rvec.shape[0], p.points.shape[0], p.obs_cam.shape[0], Jc.shape[-1]
    cam, pt = p.obs_cam.numpy(), p.obs_pt.numpy()
    U = torch.zeros((C, D, D), dtype=r.dtype)
    bc = torch.zeros((C, D), dtype=r.dtype)
    V = torch.zeros((P, 3, 3), dtype=r.dtype)
    bp = torch.zeros((P, 3), dtype=r.dtype)
    A = torch.full((O, D, 3), float("nan"), dtype=r.dtype)
    seen = np.zeros(O, dtype=int)
    cr = -(-C // ranges)
    per = (-(-O // nq) + 31) & ~31
    for q in range(nq):
        for rg in range(ranges):
            c_lo = min(C, rg * cr)
            c_hi = min(C, c_lo + cr)
            o0, o1 = q * per, min(O, q * per + per)
            for base in range(o0, o1, 32):  # a tile is whole warps of consecutive observations
                lanes = np.arange(base, base + 32)
                act = (lanes < o1) & (cam[np.minimum(lanes, O - 1)] >= c_lo) & (cam[np.minimum(lanes, O - 1)] < c_hi)
                keys = np.where(act, pt[np.minimum(lanes, O - 1)], -1)
                for o in lanes[act]:
                    seen[o] += 1
                    c = cam[o]
                    A[o] = Jc[o].T @ Jp[o]
                    U[c] += Jc[o].T @ Jc[o]
                    bc[c] -= Jc[o].T @ r[o]
                heads = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
                for s, e in zip(heads, np.r_[heads[1:], 32]):
                    if keys[s] < 0:
                        continue
                    run = lanes[s:e][act[s:e]]
                    V[keys[s]] += torch.einsum("oij,oik->jk", Jp[run], Jp[run])
                    bp[keys[s]] -= torch.einsum("oij,oi->j", Jp[run], r[run])
    assert np.array_equal(seen, np.ones(O, dtype=int))
    return U, V, bc, bp, A


def test_kernel_refuses_cpu_tensors():
    """The kernel takes CUDA tensors only, and names the plain version."""
    p = _problem()
    p32 = p._replace(**{f: getattr(p, f).float() for f in ("cam_rvec", "cam_tvec", "points", "obs_uv")})
    with pytest.raises(ValueError, match="CUDA tensors.*plain version.*normal_equations_plain"):
        normal_eq.prepare(p32.obs_cam, p32.obs_pt, p32.obs_uv, p32.obs_valid, p32.points, p32.cam_rvec.shape[0], 6)


# the benchmark cells' cameras (portbench/configs: KITTI 07's 1 101 frames,
# KITTI 00's first 2 000, Venice's 1 778 of BAL's width 9)
CELLS = {"ba.kitti07.cg": (1101, 6), "ba.kitti00.cg": (2000, 6), "ba.venice.cg": (1778, 9)}


@pytest.mark.parametrize("cell,want", [("ba.kitti07.cg", ("smem", 1)), ("ba.kitti00.cg", ("smem", 1)),
                                       ("ba.venice.cg", ("smem", 2))])
def test_route_at_the_cells(cell, want):
    """On an H100 (227 KB a block): 1 101 and 2 000 cameras of 27 terms in
    119 and 216 kB of shared memory, Venice's 1 778 of 54 in two ranges of
    192 kB; under deterministic algorithms the ordered route."""
    n_cams, width = CELLS[cell]
    assert normal_eq.route(n_cams, width, False, H100_OPTIN) == want
    assert normal_eq.smem_bytes(n_cams, width, want[1]) <= H100_OPTIN
    assert normal_eq.route(n_cams, width, True, H100_OPTIN) == ("ordered", 1)


@pytest.mark.parametrize("n_cams,width,want", [(2152, 6, ("smem", 1)), (2153, 6, ("smem", 2)),
                                               (8608, 6, ("smem", 4)), (8609, 6, ("global", 1)),
                                               (1076, 9, ("smem", 1)), (4305, 9, ("global", 1))])
def test_route_edges(n_cams, width, want):
    """Shared memory holds 2 152 cameras of width 6 and 1 076 of width 9 a
    block; beyond MAX_RANGES ranges, global atomics."""
    assert normal_eq.route(n_cams, width, False, H100_OPTIN) == want


@pytest.mark.parametrize("width", [6, 9])
def test_camera_table_layout(width):
    p = _problem(width)
    table = _table(p)
    C = p.cam_rvec.shape[0]
    assert table.shape == (C, normal_eq.table_width(width)) and table.shape[1] % 4 == 0
    assert torch.equal(table[:, :9], rodrigues(p.cam_rvec).reshape(C, 9))
    assert torch.equal(table[:, 9:12], p.cam_tvec)
    assert torch.equal(table[:, 12:39], rodrigues_jacobian(p.cam_rvec).reshape(C, 27))
    used = 39 if width == 6 else 42
    if width == 9:
        assert torch.equal(table[:, 39:42], p.cam_intr)
    assert bool((table[:, used:] == 0).all())
    with pytest.raises(ValueError):
        normal_eq.table_width(7)


def _model_table(rvec):
    """R and dR/drvec [C,3,3,3] as csrc/normal_eq.cu `neq_table` forms
    them (series below th^2 = 1e-2, half-angle sines above), in rvec's
    precision."""
    x = (rvec * rvec).sum(-1)
    th = torch.sqrt(x + 1e-16)
    series = x < 1e-2
    sn, cs, h = torch.sin(th), torch.cos(th), torch.sin(0.5 * th)
    a = torch.where(series, 1 + x * (-1 / 6 + x * (1 / 120 - x / 5040)), sn / th)
    b = torch.where(series, 0.5 + x * (-1 / 24 + x * (1 / 720 - x / 40320)), 2 * h * h / x)
    a1 = torch.where(series, -1 / 3 + x * (1 / 30 + x * (-1 / 840 + x / 45360)), (cs * th - sn) / (x * th))
    b1 = torch.where(series, -1 / 12 + x * (1 / 180 + x * (-1 / 6720 + x / 453600)), (sn * th - 4 * h * h) / (x * x))
    K = hat(rvec)
    K2 = K @ K
    eye = torch.eye(3, dtype=rvec.dtype)
    R = eye + a[:, None, None] * K + b[:, None, None] * K2
    dR = []
    for m in range(3):
        E = hat(eye[m].expand_as(rvec))
        dR.append((a1 * rvec[:, m])[:, None, None] * K + a[:, None, None] * E
                  + (b1 * rvec[:, m])[:, None, None] * K2 + b[:, None, None] * (E @ K + K @ E))
    return R, torch.stack(dR, -1)


def test_camera_table_closed_form_equals_jacfwd():
    """The kernel's closed form of R and dR/drvec against `rodrigues` and
    `rodrigues_jacobian` (torch.func.jacfwd of the guarded formula) in
    float64: rotations up to pi, across the series' edge, inside and near
    the guarded formula's small-angle branch, and zero; and in float32
    within 1e-6 of float64, where the guarded formula as written loses up
    to ~1e-4 of dR/drvec (1 - cos(th) and the derivative's two terms
    cancel at th ~ 1e-4 to 1e-3)."""
    rng = np.random.default_rng(5)
    unit = rng.normal(size=(400, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    angle = np.concatenate([rng.uniform(0, np.pi, 300), 10 ** rng.uniform(-9, -0.5, 94),
                            [0.0999, 0.1, 0.1001, 1e-4, 1.0001e-4, 0]])
    rvec = torch.from_numpy(unit * angle[:, None])
    R, dR = _model_table(rvec)
    R64, dR64 = rodrigues(rvec), rodrigues_jacobian(rvec)
    np.testing.assert_allclose(R.numpy(), R64.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(dR.numpy(), dR64.numpy(), rtol=0, atol=1e-12)
    R32, dR32 = _model_table(rvec.float())
    assert float((R32.double() - R64).abs().max()) <= 1e-6 and float((dR32.double() - dR64).abs().max()) <= 1e-6


MODEL_CASES = {
    "width6": dict(width=6),
    "width9": dict(width=9, seed=1),
    "huber6_masked": dict(width=6, masked=True, seed=2, huber=0.05),
    "huber9_masked_shuffled": dict(width=9, masked=True, shuffled=True, seed=3, huber=2.0),
    "hot_camera_shuffled": dict(width=6, shuffled=True, long_track=70, seed=4),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_kernel_model_equals_plain(case):
    """The kernel's formulas and partition (3 observation parts, 1 and 3
    camera ranges) against the plain version in float64."""
    kw = dict(MODEL_CASES[case])
    huber = kw.pop("huber", None)
    width = kw["width"]
    p = _problem(**kw)
    want = ba.normal_equations_plain(p, huber)
    assert want.U.dtype == torch.float64
    r, Jc, Jp = _model_blocks(p, _table(p), width, huber)
    r0, Jc0, Jp0 = ba._blocks(p, huber)
    for got, ref in ((r, r0), (Jc, Jc0), (Jp, Jp0)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-9, atol=1e-12 * float(ref.abs().max()))
    for ranges in (1, 3):
        got = _model_sums(p, r, Jc, Jp, nq=3, ranges=ranges)
        for name, g, w in zip(("U", "V", "bc", "bp", "A"), got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12 * float(w.abs().max()),
                                       err_msg=f"{name}, {ranges} ranges")
