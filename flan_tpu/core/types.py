"""Semantic types and constants for flan_tpu.

JAX re-design of the reference's semantic alias layer
(reference: src/flan/defines.h:10-62). The reference uses C++ typedefs; here
they are documentation-level aliases plus the handful of numeric conventions
(dB <-> amplitude, pi constants) that the rest of the framework shares.
"""
from __future__ import annotations

import math
from typing import Union

import jax.numpy as jnp
import numpy as np

# --- Semantic aliases (documentation; reference defines.h:10-39) -------------
Second = float          # time in seconds
Frame = int             # integer sample / PV-frame index
Bin = int               # frequency-bin index
Channel = int
Frequency = float       # Hz
Magnitude = float
Amplitude = float
Sample = float
Decibel = float
Radian = float
FrameRate = float       # frames per second (may be non-integer for PV)
Harmonic = int
Meter = float
Pixel = int

ArrayLike = Union[np.ndarray, jnp.ndarray, float, int]

# --- Constants (reference defines.cpp:5-6) -----------------------------------
pi = math.pi
pi2 = 2.0 * math.pi


def decibel_to_amplitude(db: ArrayLike) -> ArrayLike:
    """dB -> linear amplitude (reference defines.h)."""
    if isinstance(db, (float, int)):
        return 10.0 ** (db / 20.0)
    return jnp.power(10.0, jnp.asarray(db) / 20.0)


def amplitude_to_decibel(amp: ArrayLike) -> ArrayLike:
    """Linear amplitude -> dB."""
    if isinstance(amp, (float, int)):
        return 20.0 * math.log10(max(amp, 1e-38))
    return 20.0 * jnp.log10(jnp.maximum(jnp.asarray(amp), 1e-38))


def power_of_2_container(x: int) -> int:
    """Smallest power of two >= x (reference FFTHelper.h)."""
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()
