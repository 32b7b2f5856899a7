"""The min-cut's CUDA graph against eager sweeps, on one NVIDIA card.

    python tools/ab_mincut_graph.py

Runs chip_smoke's 480x640 GrabCut scene (`[seg]` (b): 4 iterations, each
min-cut 4096 sweeps) with `ops/graphcut.py` as it is, where the sweeps
after the first 16 replay one CUDA graph of 16 sweeps, and with that
graph replaced by the same 16 sweeps launched one operation at a time.
One warm-up of each, then the two in turns (graph, eager, eager, graph)
so that both meet the same host load; the masks and sweep counts must be
equal. Then one 480x640 GrabCut iteration (one full min-cut) under
chip_smoke's `profile_report`, post-processing included in its wall
time. Prints the card line, the profile lines and one JSON line. Exits
non-zero if the two modes disagree or there is no card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _EagerSweeps:
    """Stands in for the captured graph: replay() runs the sweeps eagerly."""

    def __init__(self, pr, count: int):
        self.pr, self.count = pr, count

    def replay(self):
        for _ in range(self.count):
            self.pr.sweep()


@contextlib.contextmanager
def _eager(graphcut):
    captured = graphcut._sweeps_graph
    graphcut._sweeps_graph = _EagerSweeps
    try:
        yield
    finally:
        graphcut._sweeps_graph = captured


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from opencv_tpu_torch.ops import grabcut, graphcut

    if not torch.cuda.is_available():
        print("ab_mincut_graph: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    img, _, rect = cs.grabcut_scene(480, 640, cs.SEG_SCALE, np.random.default_rng(1))

    def run(mode: str):
        with _eager(graphcut) if mode == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = grabcut.grab_cut_stats(img, rect=rect, iter_count=4, device="cuda")
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    first = {mode: run(mode) for mode in ("graph", "eager")}
    secs = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        out, s = run(mode)
        secs[mode].append(s)
        ref = first["graph"][0]
        if not (torch.equal(out.mask, ref.mask) and out.sweeps == ref.sweeps):
            print(f"ab_mincut_graph: the {mode} run differs from the graph's warm-up", file=sys.stderr)
            return 1
    t0 = time.perf_counter()
    cs.profile_report("profile grabcut 480x640 1 iteration",
                      lambda: grabcut.grab_cut_stats(img, rect=rect, iter_count=1, device="cuda"),
                      first["graph"][0].sweeps[0], "sweep")
    profile_s = time.perf_counter() - t0
    med = {mode: statistics.median(v) for mode, v in secs.items()}
    print(json.dumps(dict(card=card, scene="480x640 GrabCut, 4 iterations", sweeps=first["graph"][0].sweeps,
                          capped=first["graph"][0].capped, s_graph=secs["graph"], s_eager=secs["eager"],
                          median_graph=med["graph"], median_eager=med["eager"],
                          eager_over_graph=med["eager"] / med["graph"],
                          warmup_s={m: first[m][1] for m in first},
                          profile_1_iteration_s=profile_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
