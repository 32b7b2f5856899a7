"""What holds K3 back: its kernel against copies with one part taken out,
on one NVIDIA card.

    python tools/k3_ablation.py

Builds `csrc/knn2_hamming.cu` as it is and four copies, each with one
part of the work removed by a text substitution of the source:
"no fold" (the consumers read their accumulators but keep no top-2),
"no stores" (the producer loads each tile but stores nothing into its
stage), "no product" (the consumers issue no wgmma) and "product only"
(no fold and no stores). Times each at chip_smoke's K3 shapes (2000 x
128 000 x 256 bits with ~10 % invalid rows, 2000 x 32 000 x 512 bits)
by CUDA events (chip_smoke's device_time_ms), the variants in turns,
forward then backward, and prints the medians beside the int8
tensor-core bound. Only the unmodified kernel is right; it must equal
the plain version. Also counts the warpgroup MMA instructions in the
unmodified library's SASS (cuobjdump -sass), per kernel. Prints the
card line and one JSON line; exits non-zero without a card or if the
kernel differs from its plain version.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FOLD = "    fold_tile(acc, pq, quad, j0 + ti * TT, d1, d2, i1);\n"
NO_FOLD = ("    { uint32_t x = 0;\n#pragma unroll\n      for (int i = 0; i < 64; ++i) x ^= acc[i];\n"
           "      if (x == 12345u) d1[0] = 0; }\n")
STORE = "      store_tile<W>(smem + L::B + s * L::STAGE, cur, ptid);\n"
NO_STORE = "      if (cur.v[0].x == 12345u) smem[L::B + ptid] = 1;\n"
PRODUCT = """#pragma unroll
    for (int k = 0; k < W; ++k)
      mma_s8u8(acc, da + (uint64_t)((k * KB) >> 4), dbs + (uint64_t)((k * KB) >> 4), k);
    mma_s8u8(acc, dax, dbs + (uint64_t)((W * KB) >> 4), 1);
"""
NO_PRODUCT = "    acc[0] += (uint32_t)dbs;\n"
VARIANTS = {"kernel": [], "no fold": [(FOLD, NO_FOLD)], "no stores": [(STORE, NO_STORE)],
            "no product": [(PRODUCT, NO_PRODUCT)],
            "product only": [(FOLD, NO_FOLD), (STORE, NO_STORE)]}


def build(out_dir: Path) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    from opencv_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "knn2_hamming.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k3_ablation: csrc/knn2_hamming.cu no longer holds {old!r}")
            text = text.replace(old, new)
        cu, so = out_dir / f"k3_{i}.cu", out_dir / f"libk3_{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k3_ablation: {name} does not build:\n{out}{err}")
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.knn2_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp]
        lib.knn2_launch.restype = ci
        lib.knn2_tile_rows.restype = ci
        lib._typed = True
        libs[name] = lib
    return libs


def sass_gmma(so: Path) -> dict:
    """{kernel: {warpgroup MMA opcode: count}} in the library's SASS."""
    from opencv_tpu_torch.ops.cuda import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "GMMA" in line and fn is not None:
            op = line.split("*/")[1].split()[0]
            ops = out.setdefault(fn, {})
            ops[op] = ops.get(op, 0) + 1
    return out


def main() -> None:
    import statistics

    import torch

    import chip_smoke as cs
    from opencv_tpu_torch.ops.cuda import knn

    card, _ = cs.phase_device()
    out_dir = REPO / "build" / "k3_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)
    gmma = sass_gmma(out_dir / "libk3_0.so")
    for fn, ops in gmma.items():
        print(f"[k3 sass] {fn}: " + ", ".join(f"{op} x {n}" for op, n in ops.items()), flush=True)
    dev = torch.device("cuda")
    res = {}
    for words, nq, nt, seed in ((8, 2000, 128_000, 3), (16, 2000, 32_000, 4)):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        lo, hi = -(2 ** 31), 2 ** 31
        train = torch.randint(lo, hi, (nt, words), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
        query = torch.randint(lo, hi, (nq, words), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
        valid = torch.rand(nt, generator=g, device=dev) > 0.1
        want = knn.knn2_hamming_plain(query, train, valid)
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                knn._lib = lambda name=name: libs[name]
                if name == "kernel":
                    got = knn.knn2_hamming_cuda(query, train, valid)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        cs.fail(f"K3 at {32 * words} bits differs from its plain version")
                times[name].append(cs.device_time_ms(lambda: knn.knn2_hamming_cuda(query, train, valid),
                                                     calls=5))
        bound = 2 * nq * int(valid.sum()) * 32 * words / cs.INT8_TOPS * 1e3
        key = f"{nq}x{nt}x{32 * words}"
        res[key] = dict(bound_ms=bound, **{name: statistics.median(t) for name, t in times.items()})
        print(f"[k3 ablation] {key}: int8 bound {bound:.4f} ms; " + "; ".join(
            f"{name} {statistics.median(t):.4f} ms" for name, t in times.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"k3_ablation": res, "sass_gmma": gmma}), flush=True)


if __name__ == "__main__":
    os.chdir(REPO)
    main()
