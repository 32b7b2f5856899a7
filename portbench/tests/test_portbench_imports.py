"""Nothing the harness runs imports JAX or the JAX package. Top-level
names are compared whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "opencv_tpu"}


def test_no_source_under_portbench_imports_them():
    for path in (REPO / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert all(m.split(".")[0] in {"torch", "__future__", "math", "numpy"} for m in mods), (path, mods)


def test_modules_loaded_by_the_harness():
    code = ("import sys, json; import portbench.run, portbench.readings, portbench.faults; "
            "from opencv_tpu_torch.optim import ba; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "opencv_tpu_torch" in loaded and not loaded & FORBIDDEN
