"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
BENCHMARK.json, its configuration in the file that BENCHMARK.json names,
its traffic in portbench/traffic/<traffic>.json, each metric's reader in
portbench/metrics/<metric>.py, the configuration's problem generator in
portbench/<generator>.py and its plain reference in
portbench/reference/<reference>.py. A configuration (a deployment) is
added with files and entries alone; its file brings:

- "generator" (default "generate", the closed road loop): a module whose
  `make_problem(config, traffic, seed, device)` returns a dict of the
  program's `BAProblem` fields, drawn on `device` from `seed`. The run
  passes them on as they are: `BAProblem(**fields)`, `bundle_adjust(p,
  solver="cg", iters, lambda0, huber_delta, cg_iters)` and, for the
  layer timings, `normal_equations(p, huber_delta)` and
  `schur_cg_solve(eqs, obs_cam, obs_pt, lam, fixed_cams, cg_iters)`.
  Only the CG solver is measured: no cell runs the dense one.
- "reference": a module with `bundle_adjust(fields, iters, lambda0,
  huber_delta, cg_iters, ar=None)`, returning the solved fields and then
  the cost, `residuals(fields, ar)` ([O, 2]) and `Arith()` (float64, or
  `Arith(torch.float32, tf32=True)` for the control). It imports nothing
  of the program.
- "solved" (default ["cam_rvec", "cam_tvec", "points"]): the `BAProblem`
  fields the solve estimates, in the order the reference returns them.
  The fields named cam_* sum to the camera's width, which the CG's
  roofline counts.
- "camera": its "fx" (and "fy") are read only where the traffic sets a
  Huber threshold in pixels.

Set-up (counted in setup_s from the start of this module): the program's
import, the problem generated on the card from --seed, and one solve at
the cell's shapes. Then, with --trace 0, whole solves (`iters` LM steps of
`bundle_adjust` from the same start, each ended by a synchronize) run back
to back until --seconds have passed; with --trace 1, `trace_solves` solves
run under the profiler and each layer is timed by CUDA events. Once the
window has closed and the memory peak is read, --trace 1 also runs
`trace_solves` solves with the program's recorder on, outside the
profiler, for the readers of its spans and counters (`record["program"]`).
Then the plain reference solves the same problem and a sample of the
window's solves, drawn from the seed, is compared with it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, spans  # noqa: E402
from portbench.card import Card, NoCard  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
BUILD = CHECKOUT / "build" / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "opencv_tpu"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """A cell of BENCHMARK.json under `root`, with its configuration,
    traffic and the metrics it reports."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        self.root, self.name, self.entry = root, name, cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic = json.loads((root / "portbench" / "traffic" / f"{self.entry['traffic']}.json").read_text())
        mine = [m for m in bench["end_to_end"] + bench["per_layer"] if name in m.get("workloads", [name])]
        self.end_to_end = [m for m in mine if "layer" not in m]
        self.per_layer = [m for m in mine if "layer" in m]
        self.solved = tuple(self.config.get("solved", check.SOLVED))

    def lm_settings(self) -> dict:
        """`bundle_adjust`'s settings but the solver, with the Huber
        threshold turned from pixels into normalized image units. Only the
        CG solver is measured: the layer timings and the reference run it."""
        tr = self.traffic
        if tr["solver"] != "cg":
            raise ValueError(f"traffic solver {tr['solver']!r}: only the CG solver is measured")
        px, huber = tr["huber_delta_px"], None
        if px is not None:
            cam = self.config["camera"]
            if cam["fx"] != cam["fy"]:
                raise ValueError("a Huber threshold in pixels needs fx == fy")
            huber = px / cam["fx"]
        return dict(iters=tr["lm_iters"], lambda0=tr["lambda0"], cg_iters=tr["cg_iters"], huber_delta=huber)

    def _load(self, rel: str):
        """The module in the file `rel` of this checkout, loaded by path."""
        spec = importlib.util.spec_from_file_location(f"portbench_{rel[:-3].replace('/', '_').replace('.', '_')}",
                                                      self.root / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def make_problem(self, seed: int, device) -> dict:
        """The start problem (`BAProblem`'s fields) of this cell's traffic,
        drawn from `seed` by the configuration's generator."""
        gen = self._load(f"portbench/{self.config.get('generator', 'generate')}.py")
        return gen.make_problem(self.config, self.traffic, seed, device)

    def reference(self):
        """The configuration's plain reference module."""
        return self._load(f"portbench/reference/{self.config['reference']}.py")

    def sample(self, out) -> tuple:
        """The solved fields of a solve's (problem, cost), then the cost."""
        q, c = out
        return tuple(getattr(q, f) for f in self.solved) + (c,)

    def reader(self, metric: str):
        return self._load(f"portbench/metrics/{metric}.py").read


def camera_params(fields: dict, solved) -> int:
    """The camera's width: the summed widths of the `solved` cam_* fields."""
    return sum(fields[f][0].numel() for f in solved if f.startswith("cam_"))


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def run(args, cell: Cell, card) -> tuple:
    """(result line, check lines) of one run."""
    tr = cell.traffic
    card.require(cell.entry["chips"])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv_compute_cache")
    torch.set_num_threads(1)
    import opencv_tpu_torch
    from opencv_tpu_torch.optim import ba

    if Path(opencv_tpu_torch.__file__).resolve().parents[1] != CHECKOUT:
        raise ImportError(f"opencv_tpu_torch came from {opencv_tpu_torch.__file__}, not this checkout")

    card.reset_peak()
    card.sync()
    marks = [time.perf_counter()]
    inputs = cell.make_problem(args.seed, card.device)
    p = ba.BAProblem(**inputs)
    card.sync()
    marks.append(time.perf_counter())
    kw = cell.lm_settings()
    solve = functools.partial(ba.bundle_adjust, p, solver="cg", **kw)
    solve()
    card.sync()
    marks.append(time.perf_counter())
    record = {"setup_s": marks[-1] - T0, "kind": card.kind(),
              "shapes": {"cameras": p.cam_rvec.shape[0], "points": p.points.shape[0],
                         "observations": p.obs_cam.shape[0], "camera_params": camera_params(inputs, cell.solved),
                         "lm_iters": tr["lm_iters"], "cg_iters": tr["cg_iters"]}}

    draw = np.random.default_rng([abs(args.seed), 0x5EED])
    k = tr["check_samples"]
    samples: list = []
    bad = torch.zeros((), dtype=torch.int64, device=card.device)

    def keep(i, out):
        nonlocal bad
        kept = cell.sample(out)
        bad = bad + (~torch.isfinite(kept[-1])).long()
        if len(samples) < k:
            samples.append(kept)
        elif (j := int(draw.integers(0, i + 1))) < k:
            samples[j] = kept

    if args.trace:
        outs = []
        record["trace"] = card.profile(lambda: [outs.append(solve()) for _ in range(tr["trace_solves"])],
                                       BUILD / "trace.json")
        for i, out in enumerate(outs):
            keep(i, out)
        attempted = len(outs)
        del outs
        lam = torch.tensor(tr["lambda0"], dtype=torch.float32, device=card.device)
        _no_tf32()
        eqs = ba.normal_equations(p, kw["huber_delta"])
        record["spans"] = {
            "normal_eq": card.median_ms(lambda: ba.normal_equations(p, kw["huber_delta"]), tr["layer_reps"]),
            "schur_cg_solve": card.median_ms(lambda: ba.schur_cg_solve(
                eqs, p.obs_cam, p.obs_pt, lam, p.fixed_cams, tr["cg_iters"]), tr["layer_reps"])}
        del eqs
        record["solves_traced"] = attempted
    else:
        times = []
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out = solve()
            card.sync()
            t1 = time.perf_counter()
            times.append(t1 - t0)
            keep(len(times) - 1, out)
            del out
            if t1 - t_start >= args.seconds:
                break
        record["window"] = {"seconds": t1 - t_start, "solve_times": times}
        attempted = len(times)

    peak = card.memory_peak()
    failed = int(bad)
    if args.trace:
        def solves():
            for _ in range(tr["trace_solves"]):
                solve()

        _, record["program"] = spans.recorded(solves, card)
    if card.device == "cuda":
        torch.cuda.empty_cache()

    ref = cell.reference()
    ref_out = ref.bundle_adjust(inputs, **kw)
    within, shown = check.judge(check.compare(inputs, samples, ref_out, ref, cell.solved), tr["limits"])

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = cell.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": record["kind"], "count": cell.entry["chips"], "memory_peak_bytes": peak}
    line = {"correct": bool(within and failed == 0), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if args.trace:
        t = record["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["check"] = shown
    notes = [f"card {_power_limit()}" if card.device == "cuda" else f"device {card.device}",
             "setup s: imports and device %r, problem %r, warm solve %r"
             % (marks[0] - T0, marks[1] - marks[0], marks[2] - marks[1])]
    notes += [f"check {n} {s['value']!r} limit {s['limit']!r}" for n, s in shown.items()]
    return line, notes


def main(argv=None, root=None, card=None) -> int:
    args = parse(argv)
    try:
        cell = Cell(Path(root or os.getcwd()).resolve(), args.workload)
        line, notes = run(args, cell, card or Card())
    except NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for n in notes:
        print(n, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
