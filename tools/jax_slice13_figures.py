"""The JAX package's own figures of its seven example applications, on the CPU.

    python tools/jax_slice13_figures.py

Runs each of `examples/*.py` as its users run it (`--cpu`, in a temporary
directory, at its defaults; `vo_synthetic` also at `--frames 60`, where its
loop closure reaches keyframe retrieval), parses the lines it prints, and
prints the dictionary that chip_smoke.py keeps as `JAX_FIGURES_SLICE13`:
the figures its `[apps]` phase holds the port's apps to on the card. The
machine with the card has no JAX. The seven run side by side, about two
minutes in all.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from _jax_examples import PARSERS, run_jax_example  # noqa: E402

RUNS = {"tbd_app": [], "lane_detection": [], "vo_synthetic": [], "vo_synthetic_60": ["--frames", "60"],
        "calibration_app": [], "segmentation_demo": [], "qr_demo": [], "panorama": []}


def figures(key: str) -> dict:
    name = key.removesuffix("_60")
    with tempfile.TemporaryDirectory() as tmp:
        out = PARSERS[name](run_jax_example(name, RUNS[key], tmp, timeout=1200))
    if name == "vo_synthetic":  # the last frame's state and keyframes, not every frame
        out = dict(path=out["path"], ate=out["ate"], frames=len(out["frames"]), **out["frames"][-1])
    return out


def main() -> None:
    with concurrent.futures.ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {key: pool.submit(figures, key) for key in RUNS}
        print(json.dumps({key: f.result() for key, f in futures.items()}))


if __name__ == "__main__":
    main()
