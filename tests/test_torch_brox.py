"""Brox flow of the PyTorch port against the JAX package on the CPU, on
the seeded 64x96 texture of test_torch_flow.py moved by (3, 2) px.

Tolerance: mean |flow difference| <= 1e-3 px and max <= 0.05 px, 8 px
inside the border. In the 8-px band the flow of the rolled texture is
ill-posed and amplifies last-ulp differences: there the JAX function
compiled as a whole differs from its default run (its loops compiled one
by one) by up to 1.23 px (mean 0.0032 px over the field), about as much
as the port (1.30 px, 0.0026 px). The test holds the port's whole-field
difference to within 1.5 times JAX's own. The ulps come from XLA's FMAs
in the compiled loops and from the 0.7-scaled pyramid: XLA's
interpolation einsum may fuse the two taps into an FMA.
"""

import jax
import jax.numpy as jnp
import numpy as np

from opencv_tpu.ops import brox as jbrox
from opencv_tpu_torch.ops import brox

from _torch_cpu import one_torch_thread  # noqa: F401  (autouse fixture)

from test_torch_flow import _close_flows, texture


def test_brox_agrees():
    a = texture()
    b = np.roll(a, (2, 3), axis=(0, 1))
    want = np.asarray(jbrox.brox_flow(jnp.asarray(a), jnp.asarray(b), n_levels=4))
    got = brox.brox_flow(a, b, n_levels=4, device="cpu").numpy()
    _close_flows(got[8:-8, 8:-8], want[8:-8, 8:-8])
    assert abs(np.median(got[16:-16, 16:-16, 0]) - 3.0) < 0.5
    # the border band: no further from JAX than JAX's whole-jit run is
    jit = np.asarray(jax.jit(lambda x, y: jbrox.brox_flow(x, y, n_levels=4))(
        jnp.asarray(a), jnp.asarray(b)))
    own, ours = np.abs(jit - want), np.abs(got - want)
    assert ours.mean() <= 1.5 * own.mean() and ours.max() <= 1.5 * own.max(), (
        ours.mean(), own.mean(), ours.max(), own.max())
