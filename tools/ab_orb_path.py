"""Parent against change: the ORB VO path of two checkouts on one NVIDIA card.

    python tools/ab_orb_path.py TREE [TREE ...]

Each TREE is a checkout of this repository. For each, in the order given
and each in a process of its own, the script runs that tree's
`chip_smoke.phase_main_path`: `VisualOdometry.process_sequence` over the
seeded 120-frame 480x640 scene at `ORBConfig(n_features=2000)`, one cold
run and two warm runs. Give the trees in turns (parent, change,
change, parent) so that both meet the same card and host load. Prints the
card line, one JSON line per tree run, and a summary of warm frames/s and
ATE per tree. Exits non-zero if a run fails or there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
frames, centres, K = cs.make_sequence()
res = cs.phase_main_path(frames, centres, K, warm_runs=2)
print("AB_RESULT " + json.dumps(res), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    per_tree: dict[str, list[dict]] = {}
    for tree in args.trees:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree)],
                             cwd=tree, capture_output=True, text=True, timeout=1800)
        lines = [l for l in out.stdout.splitlines() if l.startswith("AB_RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("AB_RESULT "):])
        res.pop("launches", None)
        per_tree.setdefault(tree, []).append(res)
        print(json.dumps({"tree": tree, **res}), flush=True)
    for tree, runs in per_tree.items():
        fps = [f for r in runs for f in r["fps_warm_runs"]]
        print(f"[ab] {tree}: warm frames/s median {statistics.median(fps):.3f} over {len(fps)} "
              f"runs (range {min(fps):.3f} to {max(fps):.3f}); ATE % of path "
              f"{sorted({round(r['ate_pct'], 5) for r in runs})}; keyframes "
              f"{sorted({r['keyframes'] for r in runs})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
