"""The JAX package's example applications (`examples/*.py`) run as their
users run them, and their printed figures read back.

The examples parse `sys.argv` when imported, so each runs in a
subprocess on the CPU (`--cpu`, JAX_PLATFORMS=cpu) from a directory of the
caller's choice (the panorama writes its image there). The port's apps
(`opencv_tpu_torch.examples`) print the same lines, so the parsers read
either's output. Used by tests/test_torch_examples_*.py and by
tools/jax_slice13_figures.py; imports no JAX itself.
"""

from __future__ import annotations

import ast
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_jax_example(name: str, args: list[str], cwd, timeout: float) -> str:
    """stdout of `python examples/<name>.py --cpu *args` run in `cwd`;
    fails with its stderr's tail if it exits non-zero."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"), "--cpu", *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"examples/{name}.py exited {out.returncode}:\n{out.stderr[-3000:]}")
    return out.stdout


def _one(pattern: str, text: str, flags: int = 0) -> re.Match:
    m = re.search(pattern, text, flags)
    if m is None:
        raise ValueError(f"no line matches {pattern!r} in:\n{text}")
    return m


def parse_tbd_app(text: str) -> dict:
    out = {}
    for key, label in (("pedestrians", "pedestrians:"), ("vehicles", "vehicles:")):
        m = _one(label + r"\s+MOTA=(\S+) MOTP=(\S+) TP=(\d+) FP=(\d+) FN=(\d+)", text)
        out[key] = dict(mota=float(m[1]), motp=float(m[2]), tp=int(m[3]), fp=int(m[4]), fn=int(m[5]))
    out["ok"] = _one(r"^(OK|DEGRADED)$", text, re.M)[1] == "OK"
    return out


def parse_lane_detection(text: str) -> dict:
    m = _one(r"edges: (\d+) px, segments found: (\d+)", text)
    lanes = _one(r"left lane: (FOUND|missed)\s+right lane: (FOUND|missed)", text)
    return dict(edge_px=int(m[1]), segments=int(m[2]), left=lanes[1] == "FOUND",
                right=lanes[2] == "FOUND")


def parse_vo_synthetic(text: str) -> dict:
    line = r"frame\s+\d+\s+state=(\w+)\s+keyframes=\s*(\d+) landmarks=\s*(\d+)"
    frames = [dict(state=m[1], keyframes=int(m[2]), landmarks=int(m[3])) for m in re.finditer(line, text)]
    m = _one(r"path length (\S+)\s+ATE-RMSE \(Sim3-aligned\) (\S+)", text)
    return dict(frames=frames, path=float(m[1]), ate=float(m[2]))


def parse_calibration_app(text: str) -> dict:
    found = [m[1] == "grid found" for m in re.finditer(r"view \d+: (grid found|board NOT found)", text)]
    rms = [float(v) for v in re.findall(r"RMS = (\S+) px", text)]
    k = {n: float(v) for n, v in re.findall(r"\b(fx|fy|cx|cy) (\S+) \(gt", text)}
    dropped = int(_one(r"-> dropping view (\d+)", text)[1])
    return dict(found=found, first=dict(rms=rms[0], **k), after_drop=dict(rms=rms[1]), dropped=dropped,
                ok=_one(r"^(OK|DEGRADED)$", text, re.M)[1] == "OK")


def parse_segmentation_demo(text: str) -> dict:
    gc = _one(r"grabcut: fg=(\d+) px, IoU vs truth = (\S+)", text)
    ws = _one(r"watershed: basin sizes = (\{.*\}), dam px = (\d+)", text)
    cs = _one(r"camshift: mean center error = (\S+) px over (\d+) frames", text)
    return dict(grabcut_fg_px=int(gc[1]), grabcut_iou=float(gc[2]), basin_sizes=ast.literal_eval(ws[1]),
                dam_px=int(ws[2]), camshift_err_px=float(cs[1]), camshift_frames=int(cs[2]),
                ok=_one(r"^(OK|DEGRADED)$", text, re.M)[1] == "OK")


def parse_qr_demo(text: str) -> dict:
    m = _one(r"detected: (\w+) quad:\n((?:.*\n){4})", text)
    quad = [[float(v) for v in re.findall(r"-?\d+\.?\d*", row)] for row in m[2].strip().splitlines()]
    return dict(detected=m[1] == "True", quad=quad,
                text=ast.literal_eval(_one(r"decoded: (.*)$", text, re.M)[1]),
                ok="round trip OK" in text)


def parse_panorama(text: str) -> dict:
    m = _one(r"estimated focal: (\S+) \(true \S+\); (\d+) confident pairs, tree (\[.*\])", text)
    size = _one(r"panorama (\d+)x(\d+) ->", text)
    return dict(focal=float(m[1]), pairs=int(m[2]), tree=[tuple(e) for e in ast.literal_eval(m[3])],
                size=[int(size[1]), int(size[2])])


PARSERS = {"tbd_app": parse_tbd_app, "lane_detection": parse_lane_detection,
           "vo_synthetic": parse_vo_synthetic, "calibration_app": parse_calibration_app,
           "segmentation_demo": parse_segmentation_demo, "qr_demo": parse_qr_demo,
           "panorama": parse_panorama}
