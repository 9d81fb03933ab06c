"""Accuracy gate for the polynomial atan2 (ops/fastmath.py).

The bound is what the phase-vocoder paths rely on: ~1.5e-7 rad of
atan2 error is ~9e-6 Hz at the default analysis rate. Reference outputs
are float64 numpy.
"""
import numpy as np
import jax.numpy as jnp

from flan_tpu.ops.fastmath import atan2


def test_atan2_matches_numpy():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(200000).astype(np.float32)
    x = rng.standard_normal(200000).astype(np.float32)
    # include axis-aligned and tiny-magnitude points
    y[:100] = 0.0
    x[100:200] = 0.0
    y[200:300] *= 1e-30
    got = np.asarray(atan2(jnp.asarray(y), jnp.asarray(x)))
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert np.abs(got - ref).max() < 5e-7
