"""Polynomial atan2 for the polar extractions.

The degree-15 odd minimax polynomial below is pure multiply/add with
max error 7.5e-8 on atan and ~1.5e-7 rad through the quadrant logic -
for the phase vocoder that is ~9e-6 Hz at the default analysis rate,
five orders below the 0.05 Hz golden-test gates
(tests/test_reference_golden.py). It stays because it beat jnp.arctan2
end to end: the 10-minute stereo stretch pipeline ran at 3363-3365x
realtime with it against 3263x with jnp.arctan2 on an NVIDIA H100 80GB
HBM3 at its 700 W power limit (two interleaved pairs in one process).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# atan(z) ~= z * P(z^2), z in [0, 1]; Chebyshev-fit, max err 7.5e-8
_ATAN_COEF = (0.9999999, -0.3333196, 0.19969235, -0.14016585,
              0.09906097, -0.0593671, 0.02416619, -0.004668773)


def atan_poly(z):
    z2 = z * z
    p = jnp.float32(_ATAN_COEF[-1])
    for c in _ATAN_COEF[-2::-1]:
        p = p * z2 + jnp.float32(c)
    return z * p


def atan2(y, x):
    """Four-quadrant atan2 from the [0,1] polynomial; matches
    jnp.arctan2 to ~1.5e-7 for finite inputs, (0,0) excluded (callers
    gate zero-energy points, as the polar extractions do)."""
    ay, ax = jnp.abs(y), jnp.abs(x)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    z = lo / jnp.maximum(hi, jnp.float32(1e-37))
    at = atan_poly(z)
    at = jnp.where(ay > ax, jnp.float32(np.pi / 2) - at, at)
    at = jnp.where(x < 0, jnp.float32(np.pi) - at, at)
    return jnp.where(y < 0, -at, at)
