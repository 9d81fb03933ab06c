"""DSP utility: parabolic interpolation, peak/valley finding, YIN pitch.

JAX re-design of the reference utilities
(reference: src/flan/DSPUtility.cpp, AudioInformation.cpp:18-75). The
reference walks samples sequentially per window; here the YIN difference
function runs as batched FFT correlation over ALL analysis hops at once,
and valley selection is vectorized mask/argmin logic.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def parabolic_interpolation(y0, y1, y2, x1):
    """Vertex of the parabola through three points
    (reference DSPUtility.cpp:37-44)."""
    denom = y0 - 2.0 * y1 + y2
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (y0 - y2) / denom, 0.0)
    return x1 + delta, y1 - 0.25 * (y0 - y2) * delta


def find_peaks(data: np.ndarray, max_peaks: int = -1,
               amp_order: bool = False, interpolate: bool = True
               ) -> np.ndarray:
    """Local maxima of a 1-D array -> [(x, y)], reference semantics
    (DSPUtility.cpp:55-131, golden-tested in
    tests/test_dsp_reference_golden.py): a point is a peak iff equal
    values extend to a STRICTLY lower neighbor on both sides (a flat
    shoulder on a rising slope is not a peak, and a plateau at the
    array edge is not a peak); a plateau of equal values emits ONE
    entry at its center, x = (left+right)/2 when interpolating, y
    uninterpolated. Host-side numpy over run-length-encoded equal runs
    instead of the reference's per-frame walker."""
    d = np.asarray(data, np.float64)
    n = len(d)
    if n < 3:
        return np.zeros((0, 2))
    # run-length encode equal-value runs: starts[k]..ends[k] inclusive
    change = np.nonzero(np.diff(d) != 0.0)[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change, [n - 1]])
    vals = d[starts]
    interior = (starts > 0) & (ends < n - 1)
    is_peak = np.zeros(len(starts), bool)
    is_peak[interior] = (d[starts[interior] - 1] < vals[interior]) & (
        d[ends[interior] + 1] < vals[interior])
    s, e, v = starts[is_peak], ends[is_peak], vals[is_peak]
    plateau = e > s                      # run length >= 2
    frame = np.where(plateau, (s + e) // 2, s)  # floor((l+r)/2) == (s+e)//2
    if interpolate:
        # non-plateau: parabolic vertex; plateau: exact center (may be .5)
        y0 = d[np.maximum(frame - 1, 0)]
        y2 = d[np.minimum(frame + 1, n - 1)]
        denom = y0 - 2 * v + y2
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom,
                         0.0)
        xs = np.where(plateau, (s - 1 + e + 1) / 2.0, frame + delta)
        ys = np.where(plateau, v, v - 0.25 * (y0 - y2) * delta)
    else:
        xs = frame.astype(np.float64)
        ys = v
    peaks = np.stack([xs, ys], axis=-1)
    if amp_order:
        peaks = peaks[np.argsort(-peaks[:, 1], kind="stable")]
    if max_peaks != -1:
        peaks = peaks[:max_peaks]
    return peaks


def find_valleys(data: np.ndarray, max_peaks: int = -1,
                 amp_order: bool = False, interpolate: bool = True
                 ) -> np.ndarray:
    p = find_peaks(-np.asarray(data, np.float64), max_peaks, amp_order,
                   interpolate)
    if len(p):
        p[:, 1] *= -1
    return p


def mean_and_sd(data) -> Tuple[float, float]:
    d = np.asarray(data, np.float64)
    if d.size == 0:
        return 0.0, 0.0
    return float(d.mean()), float(d.std())


@functools.partial(jax.jit, static_argnames=("window_size",))
def yin_d_prime_batched(windows: jnp.ndarray, *, window_size: int
                        ) -> jnp.ndarray:
    """Cumulative-mean-normalized YIN difference function for a batch.

    windows: [H, window_size]. Returns d' [H, window_size // 2].
    The modified autocorrelation runs as full-window x half-window FFT
    correlation (reference compute_d, AudioInformation.cpp:18-57), batched
    over every analysis hop at once; the reference computes one hop at a
    time.
    """
    n = window_size
    half = n // 2
    sq = windows * windows
    # power_terms[tau] = sum_{j=tau}^{tau+n/2-1} x_j^2
    csum = jnp.cumsum(sq, axis=-1)
    zero = jnp.zeros_like(csum[..., :1])
    csum0 = jnp.concatenate([zero, csum], axis=-1)
    taus = jnp.arange(half)
    power = csum0[..., taus + half] - csum0[..., taus]

    full_fft = jnp.fft.rfft(windows, n=n, axis=-1)
    half_fft = jnp.fft.rfft(
        jnp.where(jnp.arange(n) < half, windows, 0.0), n=n, axis=-1)
    corr = jnp.fft.irfft(full_fft * jnp.conj(half_fft), n=n,
                         axis=-1)[..., :half]
    # jnp.fft normalizes irfft by n; the reference divides its unnormalized
    # FFTW result by n, so values align directly.
    d = power[..., :1] + power - 2.0 * corr

    # cumulative mean normalization: d'[tau] = d[tau] * tau / sum_{1..tau}
    dsum = jnp.cumsum(d[..., 1:], axis=-1)
    dp = jnp.where(dsum > 0, d[..., 1:] * taus[1:] / dsum, 1.0)
    return jnp.concatenate([jnp.ones_like(d[..., :1]), dp], axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("minimum_wavelength",))
def select_wavelength_batched(d_prime: jnp.ndarray, *,
                              absolute_cutoff: float = 0.2,
                              minimum_wavelength: int = 10) -> jnp.ndarray:
    """Per-hop wavelength from d' valleys (reference
    Audio::get_local_wavelength, AudioInformation.cpp:138-166):
    take the lowest valley beyond minimum_wavelength, then the smallest-lag
    valley within 2x of it (octave-error suppression); 0 if above cutoff.
    """
    h, half = d_prime.shape
    y0 = d_prime[:, :-2]
    y1 = d_prime[:, 1:-1]
    y2 = d_prime[:, 2:]
    is_valley = (y1 < y0) & (y1 <= y2)
    lag = jnp.arange(1, half - 1)
    xs, ys = parabolic_interpolation(y0, y1, y2, lag[None, :])
    valid = is_valley & (xs > minimum_wavelength)

    big = jnp.float32(1e30)
    ys_masked = jnp.where(valid, ys, big)
    min_y = jnp.min(ys_masked, axis=-1, keepdims=True)
    # The BARE 2x band, exactly as the reference: when the interpolated
    # minimum overshoots NEGATIVE, y < 2*y_min excludes every valley
    # (including the minimum itself: y<0 makes y < 2y false), best stays
    # the default (0,0), and the hop reports wavelength 0 — an accident
    # of the rule the wavetable golden (wt_wl, cutoff=1) pins
    # (AudioInformation.cpp:156-165).
    near = valid & (ys < min_y * 2.0)
    # smallest lag among 'near' valleys
    first = jnp.argmax(near, axis=-1)
    any_near = jnp.any(near, axis=-1)
    rows = jnp.arange(h)
    best_x = jnp.where(any_near, xs[rows, first], 0.0)
    best_y = jnp.where(any_near, ys[rows, first], 0.0)
    return jnp.where(best_y < absolute_cutoff, best_x, 0.0)
