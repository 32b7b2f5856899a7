"""Readings that the limits of `correct` are set from, for one cell, in
one process:

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 --control 3 [--faults]

For each seed: the problem generated as a run generates it, the program's
`check_samples` solves (after one warm solve in the process) and the
reference's solve, compared as a run compares them (`program`). For the
first `--control` seeds also the control, the reference computed with
TF32 products in the program's place (`control`), and with `--faults`
each planted fault of portbench/faults.py under the program. One JSON
line per seed; no window, no timing metric. Not run by the benchmark.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

import torch

from portbench import check
from portbench.card import Card
from portbench.faults import FAULTS
from portbench.run import Cell


def readings(cell: Cell, seeds, n_control: int, faults: bool, card) -> list:
    from opencv_tpu_torch.optim import ba

    tr = cell.traffic
    ref = cell.reference()
    kw = cell.lm_settings()
    rows = []
    for i, seed in enumerate(seeds):
        inputs = cell.make_problem(seed, card.device)
        p = ba.BAProblem(**inputs)
        solve = functools.partial(ba.bundle_adjust, p, solver="cg", **kw)
        if i == 0:
            solve()
        t0 = time.perf_counter()
        outs = [solve() for _ in range(tr["check_samples"])]
        card.sync()
        t1 = time.perf_counter()
        ref_out = ref.bundle_adjust(inputs, **kw)
        card.sync()
        t2 = time.perf_counter()
        row = {"seed": seed, "program": check.compare(inputs, [cell.sample(o) for o in outs], ref_out, ref,
                                                      cell.solved),
               "program_s": (t1 - t0) / len(outs), "reference_s": t2 - t1}
        del outs
        if i < n_control:
            ctl = ref.bundle_adjust(inputs, ar=ref.Arith(torch.float32, tf32=True), **kw)
            row["control"] = check.compare(inputs, [ctl], ref_out, ref, cell.solved)
            if faults:
                for name, fault in FAULTS.items():
                    out = fault(ba.bundle_adjust)(p, solver="cg", **kw)
                    row[name] = check.compare(inputs, [cell.sample(out)], ref_out, ref, cell.solved)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3, help="read the control on the first N seeds")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    cell = Cell(Path(os.getcwd()).resolve(), args.workload)
    card = Card()
    card.require(cell.entry["chips"])
    rows = readings(cell, [int(s) for s in args.seeds.split(",")], args.control, args.faults, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
