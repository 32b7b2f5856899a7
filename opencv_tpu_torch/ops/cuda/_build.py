"""Build the native sources of `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a, and each host
source `csrc/<name>.cpp` (the Munkres solver) by the host C++ compiler,
into its own shared library with a plain C interface (no PyTorch
headers: seconds, not minutes, per build) under `build/opencv_tpu_torch/`
at the repository root. The file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. A failed build raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "opencv_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
KERNEL_SOURCES = ("fast", "knn2_hamming", "lk_sample")
HOST_SOURCES = ("munkres",)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # compiler output per source (ptxas resource use)


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("opencv_tpu_torch: nvcc not found (set CUDA_HOME)")
    return found


def cxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("opencv_tpu_torch: g++ not found")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """(source file, compiler flags) of `name`."""
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", CXX_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNEL_SOURCES + HOST_SOURCES) -> dict[str, float]:
    """Compile every source that has no up-to-date library, all compiler
    processes started together. Returns seconds per source built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src, flags = _source(name)
        compiler = cxx_path() if name in HOST_SOURCES else nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [compiler, *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ),
            tmp, out,
        )
    times, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_logs[name] = stdout + stderr
        if proc.returncode != 0:
            errors.append(f"{_source(name)[0].name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` or `.cpp`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if code != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code}: {fn(code).decode()}")
