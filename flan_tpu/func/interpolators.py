"""Interpolators: [0,1] -> [0,1] shaping curves.

JAX port surface of the reference Interpolator set
(reference: src/flan/Utility/Interpolator.h, Interpolator.cpp). Each is a
vectorized JAX-traceable callable usable inside jitted kernels.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import jax.numpy as jnp

_SQRT2 = math.sqrt(2.0)


def midpoint(x):
    return jnp.full_like(jnp.asarray(x, jnp.float32), 0.5)


def nearest(x):
    return jnp.round(jnp.asarray(x, jnp.float32))


def floor(x):
    return jnp.zeros_like(jnp.asarray(x, jnp.float32))


def ceil(x):
    return jnp.ones_like(jnp.asarray(x, jnp.float32))


def linear(x):
    return jnp.asarray(x, jnp.float32)


def smoothstep(x):
    x = jnp.asarray(x, jnp.float32)
    return x * x * (3.0 - 2.0 * x)


def smootherstep(x):
    x = jnp.asarray(x, jnp.float32)
    return x * x * x * (x * (x * 6.0 - 15.0) + 10.0)


def sine(x):
    """(1 - cos(pi x)) / 2 (reference Interpolator.cpp sine)."""
    x = jnp.asarray(x, jnp.float32)
    return (1.0 - jnp.cos(jnp.pi * x)) / 2.0


def sine2(x):
    """sqrt(2) * sin(pi/4 * x) (reference Interpolator.cpp sine2)."""
    x = jnp.asarray(x, jnp.float32)
    return _SQRT2 * jnp.sin(jnp.pi / 4.0 * x)


def sqrt(x):
    return jnp.sqrt(jnp.maximum(jnp.asarray(x, jnp.float32), 0.0))


def interpolate_points(points: Sequence[Tuple[float, float]],
                       interp: Callable = linear) -> Callable:
    """Piecewise function through points (reference Interpolator.cpp)."""
    xs = jnp.asarray([p[0] for p in points], jnp.float32)
    ys = jnp.asarray([p[1] for p in points], jnp.float32)

    def fn(t):
        t = jnp.asarray(t, jnp.float32)
        idx = jnp.clip(jnp.searchsorted(xs, t, side="left"), 1, len(xs) - 1)
        x0, x1 = xs[idx - 1], xs[idx]
        y0, y1 = ys[idx - 1], ys[idx]
        mix = interp(jnp.clip((t - x0) / jnp.maximum(x1 - x0, 1e-20), 0, 1))
        out = (1.0 - mix) * y0 + mix * y1
        out = jnp.where(t <= xs[0], ys[0], out)
        return jnp.where(t >= xs[-1], ys[-1], out)

    return fn


def interpolate_intervals(delta_x: float, ys: Sequence[float],
                          interp: Callable = linear) -> Callable:
    """Evenly spaced variant of interpolate_points."""
    pts = [(i * delta_x, y) for i, y in enumerate(ys)]
    return interpolate_points(pts, interp)
