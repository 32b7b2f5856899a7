"""The JAX package's own stereo and flow figures on chip_smoke.py's inputs,
on the CPU.

    python tools/jax_slice8_figures.py

chip_smoke.py's `[stereo]` and `[flow]` lines print the port's bad-pixel
rates, endpoint errors and interior median offsets beside the JAX
package's on the same inputs: `stereo_pair()` (480x640, background 8 px,
blocks at 24 and 40 px, 64 disparities; BM, SGBM, BP and CSBP with the
parameters of `stereo_methods`) and `flow_pair()` of the scene's frame 0
(Farneback, TV-L1 and Brox at their defaults). It also measures Brox's
own spread on the scene crop `FLOW_CROP` of that pair: the JAX function
compiled whole against its default run, and the port on the CPU with its
first frame one ulp up (mean and max |flow difference|, px). The machine
with the card
has no JAX, so this script computes them once on a CPU and prints the
dictionary that chip_smoke.py keeps as `JAX_FIGURES`. Takes several
minutes (eager JAX compiles each operation's shape once; BP's messages
are 80 M floats).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from opencv_tpu.ops import brox, farneback, sgbm, stereo, stereo_bp, tvl1  # noqa: E402
from opencv_tpu_torch.ops import brox as pbrox  # noqa: E402


def main():
    t0 = time.time()
    left, right, gt = cs.stereo_pair()
    lj, rj = jnp.asarray(left), jnp.asarray(right)
    nd = cs.STEREO_ND
    disp = {
        "bm": stereo.compute_disparity_bm(lj, rj, nd, block_size=9),
        "sgbm": sgbm.compute_disparity_sgbm(lj, rj, sgbm.SGBMConfig(num_disparities=nd)),
        "bp": stereo_bp.stereo_bp(lj, rj, nd, n_iters=6, n_levels=3),
        "csbp": stereo_bp.stereo_csbp(lj, rj, nd, nr_plane=6, n_iters=8),
    }
    figures = {"stereo": {k: round(cs.bad_pixel_rate(np.asarray(v), gt), 6) for k, v in disp.items()}}
    print(f"stereo done in {time.time() - t0:.1f} s: {figures['stereo']}", flush=True)

    frames, _, _ = cs.make_sequence(1, device="cpu")
    prev, nxt, field, _ = cs.flow_pair(frames[0])
    a, b = jnp.asarray(prev), jnp.asarray(nxt)
    inner = (slice(16, -16), slice(16, -16))
    flows = {"farneback": farneback.calc_optical_flow_farneback(a, b),
             "tvl1": tvl1.calc_optical_flow_tvl1(a, b), "brox": brox.brox_flow(a, b)}
    figures["flow"] = {}
    for k, v in flows.items():
        fl = np.asarray(v)
        figures["flow"][k] = dict(
            epe_px=round(float(np.linalg.norm(fl[inner] - field[inner], axis=-1).mean()), 6),
            median_offset_px=[round(float(np.median(fl[inner][..., i]) - np.median(field[inner][..., i])), 6)
                              for i in (0, 1)])
    print(f"flow done in {time.time() - t0:.1f} s", flush=True)

    # Brox's own spread on the scene crop that chip_smoke holds the card to
    # the CPU on: the JAX function compiled whole against its default run,
    # and the port on the CPU with every pixel of the first frame one ulp up
    ca, cb = (np.ascontiguousarray(x[cs.FLOW_CROP]) for x in (prev, nxt))
    want = np.asarray(brox.brox_flow(jnp.asarray(ca), jnp.asarray(cb)))
    jit = np.asarray(jax.jit(brox.brox_flow)(jnp.asarray(ca), jnp.asarray(cb)))
    with cs.torch_threads(1):
        own = pbrox.brox_flow(ca, cb, device="cpu").numpy()
        nudged = pbrox.brox_flow(np.nextafter(ca, np.float32(np.inf)), cb, device="cpu").numpy()
    figures["brox_scene_crop"] = {
        name: [float(np.abs(x - y).mean()), float(np.abs(x - y).max())]
        for name, x, y in (("jax_jit_vs_default", jit, want), ("port_cpu_one_ulp", nudged, own))}
    print(f"Brox spread on the scene crop done in {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(figures))


if __name__ == "__main__":
    main()
