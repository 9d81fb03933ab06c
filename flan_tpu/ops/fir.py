"""FIR application via block FFT convolution, and IIR->FIR truncation.

The constant-coefficient fast path for the filter family (reference
behavior: src/flan/Audio/AudioFilter.cpp
per-sample loops). A stable LTI filter's impulse response decays like r^n
(r = largest pole radius), so truncating it at K taps where |h[K:]| is
below the float32 noise floor turns the sequential recurrence into a
memory-bound FFT convolution:

    signal -> non-overlapping blocks of L -> rfft(block) * rfft(h)
           -> irfft -> overlap-add the k-1 tail into the next block

K is found adaptively by running the real filter (whatever scan
implements it) on a unit impulse and doubling until the tail is quiet -
no per-filter analytic pole bookkeeping, and the FIR is exact truncation
of the actual implementation, not a re-derivation.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("fft_size",))
def _fir_blocks(x: jnp.ndarray, h: jnp.ndarray, fft_size: int):
    """Causal conv of x [C, N] with h [K], output [C, N]; K <= fft_size/2."""
    c, n = x.shape
    k = h.shape[0]
    L = fft_size - k + 1
    nb = _cdiv(n, L)
    xp = jnp.pad(x, [(0, 0), (0, nb * L - n)]).reshape(c, nb, L)
    xp = jnp.pad(xp, [(0, 0), (0, 0), (0, fft_size - L)])

    hs = jnp.fft.rfft(h, n=fft_size)               # [B]
    xs = jnp.fft.rfft(xp, axis=-1)                 # [C, nb, B]
    full = jnp.fft.irfft(xs * hs[None, None, :], n=fft_size,
                         axis=-1)                  # [C, nb, fft]
    heads = full[..., :L]
    tails = full[..., L:L + k - 1]                 # [C, nb, k-1]
    tails_prev = jnp.concatenate(
        [jnp.zeros((c, 1, k - 1), full.dtype), tails[:, :-1]], axis=1)
    tails_prev = jnp.pad(tails_prev, [(0, 0), (0, 0), (0, L - (k - 1))])
    y = (heads + tails_prev).reshape(c, nb * L)
    return y[:, :n]


def fir_apply(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Causal FIR: y[i] = sum_j h[j] x[i-j], same length as x.

    Block size scales with K, clamped to 2^18 points so the transforms
    stay small and batched (the clamp's value on the card is an open
    question).
    """
    k = int(h.shape[0])
    fft_size = min(max(_next_pow2(2 * k), 8192), 1 << 18)
    if fft_size < 2 * k:  # K beyond the block cap: grow to fit
        fft_size = _next_pow2(2 * k)
    return _fir_blocks(x, h, fft_size)


_IR_CACHE: dict = {}


def impulse_response(run_data: Callable[[jnp.ndarray], jnp.ndarray],
                     max_len: int, *, start_len: int = 4096,
                     eps: float = 1e-8, tail_window: int = 1024,
                     cache_key=None) -> Optional[np.ndarray]:
    """Truncated impulse response of a linear constant-parameter filter.

    run_data maps data [1, K] -> [1, K] (the filter's own scan path applied
    to a unit impulse). Doubles K until the trailing tail_window samples
    fall below eps * peak (truncation error ~r^K), or
    K would reach max_len - in which case the FIR holds no advantage over
    running the scan directly and None is returned.

    cache_key (hashable, should encode the filter type + all constant
    parameters + sample rate) memoizes the host-side response so repeated
    calls skip the adaptive impulse probing entirely - the probe runs
    device scans plus device->host syncs, which would otherwise be paid on
    every filter application.
    """
    if cache_key is not None and cache_key in _IR_CACHE:
        k_found, h = _IR_CACHE[cache_key]
        if h is not None:
            # a response longer than this signal holds no advantage
            return h if h.shape[0] <= max_len else None
        if k_found >= max_len:
            return None  # previously failed to converge within this length
    k = min(start_len, _next_pow2(max_len))
    while True:
        imp = jnp.zeros((1, k), jnp.float32).at[0, 0].set(1.0)
        h = np.asarray(run_data(imp)[0])
        peak = float(np.abs(h).max())
        tail = float(np.abs(h[-min(tail_window, k // 4):]).max())
        if tail <= eps * max(peak, 1e-20):
            if cache_key is not None:
                _IR_CACHE[cache_key] = (k, h)
            # same gate as the cache-hit path: K can overshoot max_len when
            # the last doubling crosses it (k doubles past non-power-of-two
            # max_len), and then the FIR holds no advantage for THIS signal
            return h if h.shape[0] <= max_len else None
        if k >= max_len:
            if cache_key is not None:
                _IR_CACHE[cache_key] = (k, None)
            return None
        k *= 2
