"""Bundle adjustment with BAL's 9-parameter cameras (rvec, t, f, k1, k2)
in the PyTorch port, on the CPU, against the benchmark's plain reference
portbench/reference/ba_bal.py (float64, closed-form Jacobians, nothing of
the port): residuals, the 9-wide Jacobians of `_blocks` (also against
torch.func.jacfwd of the whole BAL residual), the normal equations, and
`bundle_adjust` through the dense and the CG solver; the CG's plain
products at width 9; and, with `cam_intr` None, the 6-wide path bit for
bit as it was before cameras took intrinsics.

Each tolerance is written beside its reason, and each test also reads
the reference computed with TF32 products (`Arith(float32, tf32=True)`)
and holds it outside the same tolerance."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.optim import ba as jba
from opencv_tpu_torch import convert
from opencv_tpu_torch.ops.cuda import schur_cg
from opencv_tpu_torch.optim import ba as tba
from portbench.reference import ba_bal as ref

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

N_CAMS, N_PTS = 6, 100
KW = dict(iters=10, lambda0=1e-4, huber_delta=None, cg_iters=60)
TF32 = ref.Arith(torch.float32, tf32=True)
F64 = ref.Arith()


def _bal_problem(seed, dtype=torch.float32):
    """N_CAMS cameras about a ball of N_PTS points, every point seen by
    every camera (5 % of observations invalid), BAL's intrinsics
    (f 500-800 px, k1, k2), 0.5 px noise; the start turns and moves the
    cameras, scales f by 1 %, zeroes k1 and k2 and moves the points. A
    camera with t = (small, small, -d) looks at the origin whatever its
    rotation."""
    rng = np.random.default_rng(seed)
    C, P = N_CAMS, N_PTS
    rv = np.stack([rng.normal(0, 0.05, C), rng.uniform(-np.pi, np.pi, C), rng.normal(0, 0.05, C)], 1)
    tv = np.stack([rng.normal(0, 0.3, C), rng.normal(0, 0.3, C), -rng.uniform(20, 30, C)], 1)
    intr = np.stack([rng.uniform(500, 800, C), rng.uniform(-0.1, 0.05, C), rng.uniform(-0.02, 0.02, C)], 1)
    d = rng.normal(size=(P, 3))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 5.0 * rng.random((P, 1)) ** (1 / 3)
    cam, pt = np.repeat(np.arange(C), P), np.tile(np.arange(P), C)
    truth = {k: torch.as_tensor(v) for k, v in dict(cam_rvec=rv, cam_tvec=tv, cam_intr=intr, points=pts).items()}
    O = C * P
    truth.update(obs_cam=torch.as_tensor(cam), obs_pt=torch.as_tensor(pt), obs_uv=torch.zeros(O, 2, dtype=torch.float64),
                 obs_valid=torch.ones(O, dtype=torch.bool))
    uv = ref.residuals(truth, F64) + torch.as_tensor(rng.normal(0, 0.5, (O, 2)))
    start = dict(cam_rvec=rv + rng.normal(0, 0.002, rv.shape), cam_tvec=tv + rng.normal(0, 0.05, tv.shape),
                 cam_intr=np.stack([intr[:, 0] * (1 + rng.normal(0, 0.01, C)), np.zeros(C), np.zeros(C)], 1),
                 points=pts + rng.normal(0, 0.02, pts.shape))
    fields = {k: torch.as_tensor(v, dtype=dtype) for k, v in start.items()}
    fields.update(obs_cam=torch.as_tensor(cam), obs_pt=torch.as_tensor(pt), obs_uv=uv.to(dtype),
                  obs_valid=torch.as_tensor(rng.random(O) > 0.05), fixed_cams=torch.zeros(C, dtype=torch.bool))
    return fields


def _f64(fields):
    return {k: (v.double() if v.is_floating_point() else v) for k, v in fields.items()}


def _gap(a, b):
    return float((a - b).abs().max())


def test_residuals_equal_reference():
    """float64: the same formula in another order, within 1e-9 px of
    residuals up to ~100 px. float32 against the float64 reference:
    within 5e-4 px (f32 rounding of pixels of ~400 px: measured 3.4e-5;
    TF32 products 0.21)."""
    d = _bal_problem(1)
    want = ref.residuals(_f64(d), F64)
    assert float(want.abs().max()) > 1.0  # the start is off: the residuals are not noise alone
    assert _gap(tba.residuals(tba.BAProblem(**_f64(d))), want) <= 1e-9
    assert _gap(tba.residuals(tba.BAProblem(**d)), want) <= 5e-4
    assert _gap(ref.residuals(d, TF32), want) > 5e-4


def test_block_jacobians_equal_jacfwd_and_reference():
    """`_blocks`' 9-wide camera Jacobians (rvec, t, f, k1, k2) and the
    point Jacobians in float64 against torch.func.jacfwd of the whole BAL
    residual and against the reference's closed forms: within 1e-9 of the
    largest entry of each (float64 rounding)."""
    d = _f64(_bal_problem(2))
    p = tba.BAProblem(**d)
    r, Jc, Jp = tba._blocks(p, None)
    assert Jc.shape == (N_CAMS * N_PTS, 2, 9) and Jp.shape == (N_CAMS * N_PTS, 2, 3)

    def res(cam9, X):
        P = tba.rodrigues(cam9[:3]) @ X + cam9[3:6]
        q = -P[:2] / P[2]
        s = q @ q
        return cam9[6] * (1 + cam9[7] * s + cam9[8] * s * s) * q

    cams = torch.cat([p.cam_rvec, p.cam_tvec, p.cam_intr], 1)[p.obs_cam]
    jc, jp = torch.func.vmap(torch.func.jacfwd(res, argnums=(0, 1)))(cams, p.points[p.obs_pt])
    w = p.obs_valid.double()[:, None, None]
    r_ref, Jc_ref, Jp_ref = ref.jacobians(d, None, F64)
    for got, auto, closed in ((Jc, jc * w, Jc_ref), (Jp, jp * w, Jp_ref)):
        scale = float(auto.abs().max())
        assert _gap(got, auto) <= 1e-9 * scale and _gap(got, closed) <= 1e-9 * scale
    assert _gap(r, r_ref) <= 1e-9
    _, Jc_tf32, _ = ref.jacobians(_bal_problem(2), None, TF32)
    assert _gap(Jc_tf32.double(), Jc_ref) > 1e-9 * float(Jc_ref.abs().max())


def test_normal_equations_equal_reference():
    """U [C,9,9], V, bc [C,9], bp and A [O,9,3] in float32 against the
    float64 reference: each within 3e-5 of its largest entry (float32
    sums of 100 products a camera block; entries span ~10 decades, so the
    bound is on the whole block; measured at most 4.4e-6, bp; TF32
    products 8.6e-4 to 3.2e-2)."""
    d = _bal_problem(3)
    got = tba.normal_equations(tba.BAProblem(**d))
    want = ref.normal_equations(_f64(d), None, F64)
    control = ref.normal_equations(d, None, TF32)
    assert got.U.shape == (N_CAMS, 9, 9) and got.A.shape == (N_CAMS * N_PTS, 9, 3)
    for name, g, w, c in zip(("U", "V", "bc", "bp", "A"), got, want, control):
        scale = float(w.abs().max())
        assert _gap(g.double(), w) <= 3e-5 * scale, name
        assert _gap(c.double(), w) > 3e-5 * scale, name


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_equals_reference(solver):
    """10 LM steps in float32 against the float64 reference's 10: the
    cost within 1e-5 of the reference's, every residual within 5e-3 px of
    the reference solution's (measured at most 1.5e-6 and 5.9e-4 px, the
    dense solver; TF32 products 9.8e-3 and 0.14 px)."""
    for seed in (4, 5):
        d = _bal_problem(seed)
        q, c = tba.bundle_adjust(tba.BAProblem(**d), solver=solver, **KW)
        out = ref.bundle_adjust(d, **KW)
        c_ref = float(out[-1])
        r_ref = ref.residuals(dict(_f64(d), **dict(zip(ref.SOLVED, out[:-1]))), F64)
        assert c_ref < 0.2 * float(ref.cost(_f64(d), F64))  # the solve converged, not just agreed
        assert abs(float(c) - c_ref) <= 1e-5 * c_ref
        fields = {f: getattr(q, f) for f in ref.SOLVED}
        assert _gap(ref.residuals(dict(_f64(d), **_f64(fields)), F64), r_ref) <= 5e-3
        assert torch.equal(q.obs_uv, d["obs_uv"]) and q.cam_intr.shape == (N_CAMS, 3)
    ctl = ref.bundle_adjust(d, ar=TF32, **KW)
    assert abs(float(ctl[-1]) - c_ref) > 1e-5 * c_ref
    ctl_fields = _f64(dict(zip(ref.SOLVED, ctl[:-1])))
    assert _gap(ref.residuals(dict(_f64(d), **ctl_fields), F64), r_ref) > 5e-3


def test_plain_products_at_width_9():
    """wt_x_plain and w_z_plain at width 9 against a loop over the
    observations, in float64."""
    g = torch.Generator().manual_seed(6)
    C, P, O = 5, 7, 40
    A = torch.randn(O, 9, 3, generator=g, dtype=torch.float64)
    cam, pt = torch.randint(0, C, (O,), generator=g), torch.randint(0, P, (O,), generator=g)
    x, z = torch.randn(C, 9, generator=g, dtype=torch.float64), torch.randn(P, 3, generator=g, dtype=torch.float64)
    wtx, wz = torch.zeros(P, 3, dtype=torch.float64), torch.zeros(C, 9, dtype=torch.float64)
    for o in range(O):
        wtx[pt[o]] += A[o].T @ x[cam[o]]
        wz[cam[o]] += A[o] @ z[pt[o]]
    assert _gap(schur_cg.wt_x_plain(A, cam, pt, x, P), wtx) <= 1e-12
    assert _gap(schur_cg.w_z_plain(A, cam, pt, z, C), wz) <= 1e-12


def _problem6(seed=7, n_cams=5, n_pts=60):
    """A 6-wide problem (calibrated cameras, normalized observations)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(5, 9, n_pts)], 1)
    rv, tv = np.zeros((n_cams, 3)), np.zeros((n_cams, 3))
    rv[:, 1] = np.linspace(0, 0.08, n_cams)
    tv[:, 0] = -np.linspace(0, 0.8, n_cams)
    R = tba.rodrigues(torch.as_tensor(rv)).numpy()
    cam, pt = np.repeat(np.arange(n_cams), n_pts), np.tile(np.arange(n_pts), n_cams)
    pc = np.einsum("oij,oj->oi", R[cam], pts[pt]) + tv[cam]
    uv = pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-3, (len(cam), 2))
    fixed = np.arange(n_cams) < 2
    f32 = np.float32
    return tba.BAProblem(
        cam_rvec=torch.as_tensor((rv + ~fixed[:, None] * rng.normal(0, 0.01, rv.shape)).astype(f32)),
        cam_tvec=torch.as_tensor((tv + ~fixed[:, None] * rng.normal(0, 0.05, tv.shape)).astype(f32)),
        points=torch.as_tensor((pts + rng.normal(0, 0.05, pts.shape)).astype(f32)),
        obs_cam=torch.as_tensor(cam), obs_pt=torch.as_tensor(pt), obs_uv=torch.as_tensor(uv.astype(f32)),
        obs_valid=torch.as_tensor(rng.random(len(cam)) > 0.05), fixed_cams=torch.as_tensor(fixed))


# SHA-256 of the outputs below as the 6-wide code gave them before BAProblem
# had `cam_intr` (torch 2.13 on x86-64, one thread).
SIX_WIDE_DIGEST = "05579f0a0b262149cbca0907f8b9f0d17cc21ccac79686f85e84338ffc5f49ec"


def test_six_wide_path_gives_the_bits_it_gave_before():
    """With cam_intr None: residuals, `_blocks`, the normal equations, a
    CG solve, and 4 LM steps of each solver (Huber weights on), bit for
    bit."""
    p = _problem6()
    assert p.cam_intr is None and tba.camera_width(p) == 6
    h = 3.0 / 500.0
    outs = [tba.residuals(p), *tba._blocks(p, h), *tba.normal_equations(p, h)]
    eqs = tba.normal_equations(p, h)
    outs += list(tba.schur_cg_solve(eqs, p.obs_cam, p.obs_pt, torch.tensor(1e-3), p.fixed_cams))
    for solver in ("dense", "cg"):
        q, c = tba.bundle_adjust(p, iters=4, huber_delta=h, solver=solver)
        assert q.cam_intr is None
        outs += [q.cam_rvec, q.cam_tvec, q.points, c]
    m = hashlib.sha256()
    for t in outs:
        m.update(t.contiguous().numpy().tobytes())
    assert m.hexdigest() == SIX_WIDE_DIGEST


def test_convert_of_a_jax_problem_leaves_cam_intr_none():
    p = _problem6()
    jp = jba.BAProblem(**{f: jnp.asarray(getattr(p, f).numpy()) for f in jba.BAProblem._fields})
    got = convert.ba_problem(jp, device="cpu")
    assert got.cam_intr is None
    for f in jba.BAProblem._fields:
        assert torch.equal(getattr(got, f), getattr(p, f)), f


def test_solver_rule_counts_the_camera_width():
    """'auto' keeps W [C,P,D,3] under 128 MB: 12 D bytes a (camera, point)."""
    C, P = 20, 80000  # 20 * 80000 * 72 B fits in 128 MiB, * 108 B does not
    p = tba.BAProblem(*[None] * 8)._replace(cam_rvec=torch.zeros(C, 3), points=torch.zeros(P, 3))
    assert tba._resolve_solver("auto", p) == "dense"
    assert tba._resolve_solver("auto", p._replace(cam_intr=torch.zeros(C, 3))) == "cg"


def test_sharded_step_at_width_9_world_1():
    """bundle_adjust_sharded over a gloo world of one rank takes the same
    candidate and merge as ba_step (`ba.candidate`): the CG solve's bits at
    width 9."""
    import torch.distributed as dist

    from opencv_tpu_torch.parallel import dist_ba, dryrun, mesh

    p = tba.BAProblem(**_bal_problem(8))
    want_q, want_c = tba.bundle_adjust(p, iters=3, solver="cg")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{dryrun.free_port()}", world_size=1, rank=0)
    try:
        q, c = dist_ba.bundle_adjust_sharded(p, mesh.make_mesh(device="cpu"), iters=3)
    finally:
        dist.destroy_process_group()
    assert torch.equal(c, want_c)
    for f in ref.SOLVED:
        assert torch.equal(getattr(q, f), getattr(want_q, f)), f
