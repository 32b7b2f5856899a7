"""The port's API against the JAX package's, by AST, and the last gaps it
closed held against JAX on the CPU.

`test_module_has_its_counterpart` walks `opencv_tpu/` and
`opencv_tpu_torch/` without importing either. For every module of the
JAX package it requires the module at the same relative path in the
port and there: every public module-level name (definitions,
assignments, and in a package's `__init__.py` its imports), every public
function, every public method of a public class and every field of one,
and every parameter of each function and method (the port may add
parameters: `device`, `gen`, injected draws). The only exceptions are
the entries of EXEMPT_DIRS and EXEMPT_PARAMS, each with its reason and
the port's counterpart, and the rename of PARAM_COUNTERPARTS. Each JAX
module is one case.

The rest holds the names that closed the gaps against the JAX functions
on the CPU: `brief_descriptors(method="binned")` bit for bit (on the
conftest `checker_image` and a `megamind_gray.avi` frame, at angles that
cover all 32 bins and the wrap at +-pi), `extract_patches` and
`signed_descriptors` exactly, `knn_match_auto`'s `force_streaming` both
ways against JAX's `knn_match` with cross-check off (equal matches),
the FAST rings, `DESC_BITS`, `ANGLE_BINS`, and `train_svmsgd(seed=)`.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.core.config import MatchConfig as JMatchConfig
from opencv_tpu.ops import fast as jfast, matching as jmatch, orb as jorb
from opencv_tpu_torch.core.config import MatchConfig
from opencv_tpu_torch.ml import classifiers as tcls
from opencv_tpu_torch.ops import fast as tfast, matching as tmatch, orb as torb
from opencv_tpu_torch.ops.cuda import fast_kernel

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "opencv_tpu", REPO / "opencv_tpu_torch"

# JAX directories with no module-for-module counterpart: (reason, the port's counterpart)
EXEMPT_DIRS = {
    "ops/pallas": ("Pallas kernels for the TPU",
                   "ops/cuda/*.py wrappers of the hand-written CUDA kernels in csrc/*.cu (K1-K5)"),
    "native": ("the host C++ Munkres solver and its build",
               "ops/cuda/_build.py, which builds csrc/munkres.cpp"),
}

# TPU-only switches: (JAX module, function, parameter) -> (reason, the port's counterpart)
EXEMPT_PARAMS = {
    ("ops/fast.py", "fast_score", "use_pallas"): (
        "picks the TPU's Pallas kernel", "the tensor's device: K2 on the card, its plain version on the CPU"),
    ("ops/fast.py", "fast_corners", "use_pallas"): (
        "picks the TPU's Pallas kernel", "the tensor's device: K1 on the card, its plain version on the CPU"),
    ("ops/matching.py", "knn_match_auto", "interpret"): (
        "runs the Pallas kernel in interpret mode", "a CPU tensor runs K3's plain version"),
    ("optim/ba.py", "schur_cg_solve", "psum_axis"): (
        "a shard_map axis name to psum over", "group=, a torch.distributed process group"),
    ("parallel/multihost.py", "global_sharded", "spec"): (
        "a jax.sharding.PartitionSpec", "axes=, the mesh axes the leading axis is split over"),
    ("ops/lk.py", "calc_optical_flow_pyr_lk_pairs", "phase1_chunk"): (
        "chunks the vmapped pairs to fit the TPU's memory",
        "none: the port tracks one pair at a time"),
    ("utils/guard.py", "checked", "errors"): (
        "checkify's error sets (it instruments every traced primitive)",
        "none: the port checks the outputs for non-finite values"),
}

# JAX parameter -> the port's parameter in the same place
PARAM_COUNTERPARTS = {
    "key": "gen",  # a PRNG key -> a torch.Generator; the draws differ (ROADMAP rule 4)
}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs if p.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.split(".")[-1].startswith("_")


def module_api(path: pathlib.Path) -> tuple[set[str], dict[str, list[str]]]:
    """(public names, {public function or Class.method: parameters}) of a
    module's top level. Imports count as names only in a package's
    `__init__.py` (its re-exports)."""
    tree = ast.parse(path.read_text(), str(path))
    names, funcs = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        _public(sub.name) or sub.name == "__init__"):
                    funcs[f"{node.name}.{sub.name}"] = _params(sub)
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    names.add(f"{node.name}.{sub.target.id}")
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and path.name == "__init__.py":
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return ({n for n in names if _public(n)},
            {f: p for f, p in funcs.items() if _public(f.split(".")[0])})


def port_api(path: pathlib.Path) -> tuple[set[str], dict[str, list[str]]]:
    """`module_api` of a port module, with every imported name counted: a
    name the port re-exports (e.g. ops/fast.py's rings) is supplied."""
    names, funcs = module_api(path)
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names, funcs


def _exempt_dir(rel: pathlib.PurePath) -> bool:
    return any(str(rel).startswith(d + "/") for d in EXEMPT_DIRS)


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                     if not _exempt_dir(p.relative_to(JAX_PKG)))


def coverage_gaps(rel: str) -> list[str]:
    """What the port lacks of JAX module `rel`, as readable lines."""
    port = PORT_PKG / rel
    if not port.exists():
        return [f"{rel}: no module opencv_tpu_torch/{rel}"]
    j_names, j_funcs = module_api(JAX_PKG / rel)
    p_names, p_funcs = port_api(port)
    gaps = [f"{rel}: name {n}" for n in sorted(j_names - p_names)]
    for f, params in sorted(j_funcs.items()):
        if f not in p_funcs:
            gaps.append(f"{rel}: function {f}")
            continue
        for i, p in enumerate(params):
            if (rel, f, p) in EXEMPT_PARAMS:
                continue
            want = PARAM_COUNTERPARTS.get(p, p)
            have = p_funcs[f]
            if want not in have:
                gaps.append(f"{rel}: {f}({p}=...)")
            elif p in PARAM_COUNTERPARTS and have.index(want) != i:
                gaps.append(f"{rel}: {f}: {want} is not where JAX has {p}")
    return gaps


def test_exemptions_are_real():
    """Every exemption names an existing directory or an existing parameter
    of the JAX function, which the port function indeed lacks, and says why
    and what stands in its place."""
    for d, (why, instead) in EXEMPT_DIRS.items():
        assert (JAX_PKG / d).is_dir() and why and instead
    for (rel, fn, p), (why, instead) in EXEMPT_PARAMS.items():
        assert p in module_api(JAX_PKG / rel)[1][fn], (rel, fn, p)
        assert p not in port_api(PORT_PKG / rel)[1][fn], (rel, fn, p)
        assert why and instead


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_its_counterpart(rel):
    assert not coverage_gaps(rel), "\n".join(coverage_gaps(rel))


# ------------------------------------------------------------ the names that closed the gaps


def _t(x):
    return torch.from_numpy(np.array(x))


def test_constants_equal_jax():
    assert torb.ANGLE_BINS == jorb.ANGLE_BINS == 32
    assert tmatch.DESC_BITS == jmatch.DESC_BITS == 256
    assert tmatch.STREAMING_TRAIN_THRESHOLD == jmatch.STREAMING_TRAIN_THRESHOLD
    for name in ("CIRCLE16", "CIRCLE12", "CIRCLE8", "PATTERNS"):
        assert getattr(tfast, name) == getattr(jfast, name)
        assert getattr(tfast, name) is getattr(fast_kernel, name)  # one object, not a copy


def _keypoints(img: np.ndarray, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """n sub-pixel keypoints over the image (some on and beyond the border,
    where the patch centres clamp) and angles covering each of the 32 bins
    at its centre and both its edges, with -pi, pi and the values beside
    them (the wrap of bin 0)."""
    h, w = img.shape
    xy = np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)], 1).astype(np.float32)
    step = 2 * math.pi / 32
    centres = np.arange(32) * step - math.pi
    edges = centres + step / 2
    special = [-math.pi, math.pi, np.nextafter(np.float32(math.pi), np.float32(0)),
               np.nextafter(np.float32(-math.pi), np.float32(0)), 0.0]
    ang = np.concatenate([centres, edges, np.nextafter(edges.astype(np.float32), np.float32(9)),
                          np.nextafter(edges.astype(np.float32), np.float32(-9)), special])
    ang = np.resize(ang.astype(np.float32), n)
    ang[len(special) + 128:] = rng.uniform(-math.pi, math.pi, n - len(special) - 128)
    return xy, ang


@pytest.fixture(scope="module")
def megamind_frame():
    from opencv_tpu.io.video import read_mjpeg_avi

    clip = read_mjpeg_avi(str(REPO / "benchmarks" / "data" / "megamind_gray.avi"))
    return clip[100].astype(np.float32)


@pytest.mark.parametrize("image", ["checker", "megamind"])
def test_binned_brief_bit_equal_to_jax(image, checker_image, megamind_frame, rng):
    """`method="binned"` gives the JAX package's binned descriptors bit for
    bit, on the blurred image (as ORB feeds it); every bin is hit; "auto"
    and "gather" give the exact gather, as JAX's non-TPU branch."""
    img = checker_image if image == "checker" else megamind_frame
    blurred = np.asarray(jorb.imgproc.gaussian_blur(jnp.asarray(img), 7, 2.0))
    xy, ang = _keypoints(blurred, 600, rng)
    want = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(ang),
                                             method="binned"))
    got = torb.brief_descriptors(_t(blurred), _t(xy), _t(ang), method="binned")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    qbin = np.round((ang + np.float32(math.pi)) * np.float32(32 / (2 * math.pi))).astype(np.int64) % 32
    assert set(qbin.tolist()) == set(range(32))
    gather = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(ang),
                                               method="gather"))
    for method in ("auto", "gather"):
        got = torb.brief_descriptors(_t(blurred), _t(xy), _t(ang), method=method)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), gather)
    with pytest.raises(ValueError, match="unknown method"):
        torb.brief_descriptors(_t(blurred), _t(xy), _t(ang), method="matmul")


@pytest.mark.parametrize("shape,radius", [((128, 160), 20), ((30, 50), 20), ((9, 7), 3)])
def test_extract_patches_equal_jax(shape, radius, rng):
    """Patches equal JAX's, centres clamped at every border, and an image
    smaller than a patch zero-padded as JAX pads it."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    h, w = shape
    xy = np.stack([rng.uniform(-5, w + 5, 50), rng.uniform(-5, h + 5, 50)], 1).astype(np.float32)
    xy[:4] = [[0.5, 0.5], [1.5, 2.5], [w - 0.5, h - 0.5], [radius + 0.5, radius - 0.5]]  # ties round to even
    want = np.asarray(jorb.extract_patches(jnp.asarray(img), jnp.asarray(xy), radius))
    got = torb.extract_patches(_t(img), _t(xy), radius)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("words", [8, 16])
def test_signed_descriptors_equal_jax(words, rng):
    desc = rng.integers(0, 2 ** 32, (40, words), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jmatch.signed_descriptors(jnp.asarray(desc)).astype(jnp.float32))
    got = tmatch.signed_descriptors(_t(desc.view(np.int32)))
    assert got.dtype == torch.bfloat16 and got.shape == (40, 32 * words)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("force", [True, False, None])
def test_knn_match_auto_force_streaming_equals_jax_knn_match(force, rng):
    """Forced either way (and by size: 300 rows stream under a threshold of
    256), the matches equal the JAX package's dense `knn_match` with
    cross-check off: the same best index, distance and verdict."""
    train = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    query = train[rng.integers(0, 300, 120)].copy()
    query[:, 0] ^= rng.integers(0, 2 ** 32, 120, dtype=np.uint64).astype(np.uint32) & np.uint32(0x0F0F)
    query[:20] = rng.integers(0, 2 ** 32, (20, 8), dtype=np.uint64).astype(np.uint32)
    train[50:60] = train[40:50]  # exact ties
    qv, tv = rng.random(120) > 0.1, rng.random(300) > 0.1
    cfg = dict(ratio=0.8, max_distance=64.0, cross_check=False)
    want = jmatch.knn_match(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv), jnp.asarray(tv),
                            JMatchConfig(**cfg))
    got = tmatch.knn_match_auto(_t(query.view(np.int32)), _t(train.view(np.int32)), _t(qv), _t(tv),
                                MatchConfig(**cfg), streaming_threshold=256, force_streaming=force)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    np.testing.assert_array_equal(got.train_idx.numpy()[ok], np.asarray(want.train_idx)[ok])
    np.testing.assert_array_equal(got.distance.numpy()[ok], np.asarray(want.distance)[ok])


def test_train_svmsgd_seed(rng):
    """`seed` seeds the port's own draws when no generator or indices are
    given: the same seed the same model, another seed another one."""
    x = rng.normal(0, 1, (200, 4)).astype(np.float32)
    y = np.where(x[:, 0] + 0.3 * x[:, 1] > 0, 1, -1).astype(np.int32)

    def fit(**kw):
        return tcls.train_svmsgd(_t(x), _t(y), iters=500, **kw)

    a, b, c = fit(seed=3), fit(seed=3), fit(seed=4)
    assert torch.equal(a.weights, b.weights) and not torch.equal(a.weights, c.weights)
    assert torch.equal(fit().weights, fit(seed=0).weights)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(fit(gen=gen, seed=9).weights, a.weights)  # a generator given wins
