"""Overlap-save FFT convolution.

The reference computes full-length FFT convolution with one giant FFTW
transform (reference: src/flan/Audio/AudioCombination.cpp:299-353).
Here the signal streams through power-of-two blocks sized to the impulse
response: every block's (i)rFFT is one *batched* transform, and the valid
tails concatenate to the exact linear convolution. Whether this beats one
whole-signal transform on the card is not measured; it keeps the
transforms small and batched, and the granular-texture mix
(impulse-train convolution, AudioSynthesis.cpp:401-421 equivalent)
shares it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.core.types import power_of_2_container

# largest block transform; longer impulse responses take one whole-signal
# transform instead
_MAX_DFT = 1 << 18


def _plan(n: int, m: int):
    """Choose (dft, step, nblocks) for x-length n, ir-length m."""
    dft = max(4096, 2 * power_of_2_container(m))
    if dft > _MAX_DFT:
        return None  # ir too long for blocking; caller falls back
    step = dft - (m - 1)
    nblocks = -(-(n + m - 1) // step)
    return dft, step, nblocks


@jax.jit
def fft_convolve_full(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Full linear convolution along the last axis: [C, n] conv [C, m]
    -> [C, n + m - 1] (callers pad/trim to their length conventions).

    Jitted at module level: the blocked form is ~100 primitives, which
    eager dispatch would issue one by one. All control flow is
    shape-static so the jit caches per (n, m, C)."""
    c, n = x.shape
    assert h.shape[0] == c, (x.shape, h.shape)
    m = h.shape[-1]
    if m > n:  # convolution commutes; block over the longer signal
        return fft_convolve_full(h, x)
    plan = _plan(n, m)
    if plan is None:
        # impulse response too long to block: one whole-signal transform
        dft = 2 * power_of_2_container(max(n, m))
        spec = (jnp.fft.rfft(x, n=dft, axis=-1)
                * jnp.fft.rfft(h, n=dft, axis=-1))
        return jnp.fft.irfft(spec, n=dft, axis=-1)[:, :n + m - 1]

    dft, step, nblocks = plan
    # overlap-save: pad m-1 zeros left; block i reads [i*step, i*step+dft)
    total = (nblocks - 1) * step + dft
    xp = jnp.pad(x, [(0, 0), (m - 1, total - (m - 1) - n)])
    blocks = jnp.stack(
        [jax.lax.slice(xp, (0, i * step), (c, i * step + dft))
         for i in range(nblocks)], axis=1)          # [C, nb, dft]

    hs = jnp.fft.rfft(h, n=dft, axis=-1)             # [C, bins]
    xs = jnp.fft.rfft(blocks, axis=-1)               # [C, nb, bins]
    y = jnp.fft.irfft(xs * hs[:, None, :], n=dft, axis=-1)  # [C, nb, dft]
    # the first m-1 samples of each block alias (circular); keep the rest
    valid = y[:, :, m - 1:].reshape(c, nblocks * step)
    return valid[:, :n + m - 1]
