"""The PyTorch port stands alone: no module of `opencv_tpu_torch/` and not
`chip_smoke.py` imports jax or the JAX package, importing the port does
no device work, and `chip_smoke.py` fails without a card or without the
repository around it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "opencv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "opencv_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_slice_module_is_checked():
    """The import checks below walk the whole package; the LK slice's
    modules are among them."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/lk.py", "ops/gftt.py", "ops/cuda/lk_sample.py", "core/pyramid.py",
                "slam/vo.py"):
        assert f"opencv_tpu_torch/{mod}" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT_FILES[:-1]
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from opencv_tpu_torch.ops.cuda import _build\n"
        "bad = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'opencv_tpu')]\n"
        "assert not bad, bad\n"
        "assert not _build._libs\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    """Here there is no card; alone in a directory it has no port either.
    Both runs must exit non-zero and print no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
