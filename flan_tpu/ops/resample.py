"""Sample-rate conversion kernels.

JAX replacements for the reference's two resampler dependencies
(SURVEY.md native-component checklist):

* r8brain whole-buffer SRC (reference src/r8brain/CDSPResampler.h:46, used by
  Audio::resample, AudioConversions.cpp:14-30) -> rational polyphase
  windowed-sinc resampling expressed as one matrix product per output
  block instead of scalar polyphase loops.

* WDL streaming variable-rate SRC (reference src/WDL/resample.cpp, used by
  repitch / doppler / wavetable) -> time-varying fractional-delay
  resampling: the read-position curve is integrated (prefix sum), then the
  output is a dense gather of K-tap windowed-sinc interpolations, vectorized
  over all output frames.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def design_lowpass(num_taps: int, cutoff: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc FIR, cutoff in [0, 1] of Nyquist-normalized
    frequency (1 = Nyquist of the sampling rate the filter runs at)."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    w = np.i0(beta * np.sqrt(np.clip(
        1 - (2 * n / (num_taps - 1)) ** 2, 0, 1))) / np.i0(beta)
    return (h * w).astype(np.float64)


@functools.cache
def _rational_filter(L: int, M: int, taps_per_phase: int,
                     atten_db: float) -> np.ndarray:
    """Anti-aliasing/anti-imaging filter for L/M rational resampling,
    designed at the upsampled rate L*sr with gain L."""
    cutoff = 1.0 / max(L, M)
    num_taps = taps_per_phase * L
    if num_taps % 2 == 0:
        num_taps += 1
    h = design_lowpass(num_taps, cutoff, _kaiser_beta(atten_db)) * L
    return h.astype(np.float32)


@functools.cache
def _polyphase_matrix(L: int, M: int, taps_per_phase: int, atten_db: float):
    """Dense per-block weight matrix for L/M polyphase resampling.

    Output sample n reads upsampled position e = n*M + c (c centers the
    filter); only taps s with (e - s) % L == 0 touch real input, giving
    y[n] = sum_j h[ph_p + L*j] * x[e//L - j] with p = n % L. Folding the
    phase structure into one [L, window] matrix turns each L-output block
    into a single matmul - XLA's dilated-conv lowering of the same
    filter runs ~3 orders of magnitude more MACs (it multiplies every
    output by all L*taps dense taps, zeros included).

    Returns (mat [L, win], off) with y[bL + p] = sum_w mat[p, w] *
    x[b*M + off + w].
    """
    h = _rational_filter(L, M, taps_per_phase, atten_db).astype(np.float64)
    k = h.shape[0]
    kk = -(-k // L)                                 # taps per phase
    hp = np.zeros((kk * L,), np.float64)
    hp[:k] = h
    c = k - 1 - (k - 1) // 2                        # center (matches conv)
    p = np.arange(L)
    e = p * M + c
    ph = e % L                                      # starting tap phase
    d = e // L                                      # input index offset
    j = np.arange(kk)
    xi = d[:, None] - j[None, :]                    # [L, kk] input offsets
    off = int(xi.min())
    win = int(xi.max()) - off + 1
    mat = np.zeros((L, win), np.float64)
    taps = hp[(ph[:, None] + L * j[None, :]).reshape(-1)].reshape(L, kk)
    np.add.at(mat, (np.repeat(p, kk), (xi - off).reshape(-1)),
              taps.reshape(-1))
    return mat.astype(np.float32), off


@functools.partial(jax.jit, static_argnames=("L", "M", "num_out",
                                             "taps_per_phase", "atten_db"))
def _rational_resample_jit(x, L: int, M: int, num_out: int,
                           taps_per_phase: int, atten_db: float):
    mat_np, off = _polyphase_matrix(L, M, taps_per_phase, atten_db)
    mat = jnp.asarray(mat_np)
    win = mat_np.shape[1]
    c_cnt, n = x.shape
    nb = -(-num_out // L)
    # block b covers input [b*M + off, b*M + off + win); pad so every
    # block is in range, then build windows from M-strided rows plus the
    # overlapping heads of following rows (static slices, no gather)
    left = max(0, -off)
    nrows_extra = -(-win // M) + 1
    total = (nb + nrows_extra) * M
    xp = jnp.pad(x, [(0, 0), (left, max(0, total - n - left))])
    if off + left > 0:
        xp = xp[:, off + left:]
        xp = jnp.pad(xp, [(0, 0), (0, off + left)])
    rows = xp[:, :(nb + nrows_extra) * M].reshape(c_cnt, nb + nrows_extra, M)
    parts = [rows[:, i:i + nb, :] for i in range(nrows_extra)]
    window = jnp.concatenate(parts, axis=-1)[..., :win]   # [C, nb, win]
    # HIGHEST: the reduced-precision default (TF32 on GPUs) would cap the
    # output near 40 dB SNR, defeating the 140 dB filter design.
    y = jnp.einsum("cbw,pw->cbp", window, mat,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return y.reshape(c_cnt, nb * L)[:, :num_out]


def resample(x: jnp.ndarray, sr_in: float, sr_out: float,
             taps_per_phase: int = 64, atten_db: float = 140.0,
             max_denominator: int = 1000) -> jnp.ndarray:
    """Whole-buffer SRC of [C, N] audio (r8brain equivalent).

    Output length matches the reference's truncation
    num_frames * sr_out / sr_in (AudioConversions.cpp:22).

    taps_per_phase=64 from an A/B against the compiled reference's
    r8brain output (conv_resample golden): 24 taps measures 37.6 dB,
    32 -> 44.4, 48 -> 47.2, 64 -> 48.1 (the residual past the knee is
    transition-band shape, not tap count). 48 would pass the one-pass
    golden, but the oversampled-waveshape ROUND TRIP (two passes,
    vol_waveshape golden) compounds to 38.7 dB there vs >=40 at 64.
    The numerics gate (flan_tpu/utils/gates.py gate_resample) is
    taps-independent at ~79 dB.
    """
    if sr_in == sr_out:
        return x
    frac = Fraction(sr_out / sr_in).limit_denominator(max_denominator)
    L, M = frac.numerator, frac.denominator
    num_out = int(x.shape[-1] * (sr_out / sr_in))
    return _rational_resample_jit(x, L, M, num_out, taps_per_phase, atten_db)


@functools.partial(jax.jit, static_argnames=("num_taps",))
def fractional_gather(x: jnp.ndarray, positions: jnp.ndarray,
                      cutoff: jnp.ndarray, num_taps: int = 32) -> jnp.ndarray:
    """Windowed-sinc interpolation of [C, N] at fractional sample positions.

    positions: [num_out] read positions in input frames. cutoff: [num_out]
    per-output lowpass cutoff in (0, 1] (1 = input Nyquist) - pass
    min(1, 1/rate) to antialias downward pitch sweeps. This is the WDL
    variable-rate resampler equivalent: one dense gather + dot instead of a
    streaming filter. Positions outside the input read zeros.
    """
    c, n = x.shape
    num_out = positions.shape[0]
    base = jnp.floor(positions).astype(jnp.int32)
    frac = positions - base
    offs = jnp.arange(-(num_taps // 2 - 1), num_taps // 2 + 1)  # [K]
    idx = base[:, None] + offs[None, :]                          # [O, K]
    valid = (idx >= 0) & (idx < n)
    samples = jnp.take(x, jnp.clip(idx, 0, n - 1), axis=-1)      # [C, O, K]
    samples = jnp.where(valid[None], samples, 0.0)

    # Kaiser-windowed sinc taps evaluated at (offs - frac) * cutoff
    t = (offs[None, :] - frac[:, None]) * cutoff[:, None]        # [O, K]
    sinc = jnp.sinc(t) * cutoff[:, None]
    # polynomial Kaiser approx via cosine window (Blackman-Harris-ish) over
    # the tap span; cheap and >90 dB for 32 taps
    u = (offs[None, :] - frac[:, None]) / (num_taps / 2)
    u = jnp.clip(u, -1.0, 1.0)
    w = (0.35875 + 0.48829 * jnp.cos(jnp.pi * u)
         + 0.14128 * jnp.cos(2 * jnp.pi * u)
         + 0.01168 * jnp.cos(3 * jnp.pi * u))
    taps = sinc * w
    return jnp.einsum("cok,ok->co", samples, taps,
                      precision=jax.lax.Precision.HIGHEST)


def variable_rate_positions(rate_per_block: np.ndarray,
                            block_frames: int) -> np.ndarray:
    """Integrate per-block read rates into per-output-frame read positions.

    Mirrors the reference's blockwise WDL loop (AudioTemporal.cpp:267-296):
    each block of block_frames output frames advances the input read head at
    a constant rate. Host-side; the result feeds fractional_gather.
    """
    nblocks = len(rate_per_block)
    starts = np.concatenate(
        [[0.0], np.cumsum(rate_per_block.astype(np.float64))
         * block_frames])[:-1]
    local = np.arange(block_frames, dtype=np.float64)
    pos = starts[:, None] + local[None, :] * rate_per_block[:, None]
    return pos.reshape(-1)
