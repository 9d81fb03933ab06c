"""STFT phase-vocoder forward/inverse kernels.

JAX re-design of the reference's sequential hop-loop phase vocoder
(reference: src/flan/Conversions/AudioPV.cpp:12-139, phase_vocoder.cpp:5-61).

Key re-architecture decisions (SURVEY.md section 7):

* The reference's per-hop loop is sequential only because a phase buffer is
  carried. Mathematically the forward phase delta is a lag-1 difference along
  the hop axis, so the whole transform is computed as one batched tensor
  program: frame-gather -> batched rFFT -> vectorized phase math.

* The inverse transform's phase accumulator is an inclusive prefix sum of
  per-frame phase increments. Accumulating raw radians in float32 loses all
  precision after minutes of audio (the reference uses double); instead we
  accumulate *cycles modulo 1* with `jax.lax.associative_scan` whose combine
  op is (a + b) mod 1 - associative, keeps every intermediate in [0, 1), and
  bounds the error at O(log n * eps) instead of O(n^2 * eps).

* Overlap-add is computed without scatters: each windowed ifft frame is split
  into window/hop blocks and the R diagonals are summed with static slices.

* Both directions stream over hop-chunks with `jax.lax.scan` so peak HBM use
  stays bounded for long audio; the carried state is exactly the per-bin
  phase (forward) / cycle offset (inverse) plus the overlap-add tail.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.ops.windows import hann_window


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def num_hops(num_frames: int, hop: int) -> int:
    """PV frame count: N // hop + 1 (reference AudioPV.cpp:17).

    The reference writes `std::ceil(get_num_frames() / hopSize) + 1`, but
    both operands are int32 `Frame`s, so the division floors before ceil
    sees it - the quirk is preserved here so .flan frame counts and
    round-trip lengths match byte-for-byte.
    """
    return num_frames // hop + 1


def _frame_signal(x: jnp.ndarray, start_hop, chunk_hops: int, hop: int,
                  window_size: int) -> jnp.ndarray:
    """Gather hann-analysis frames for hops [start_hop, start_hop+chunk_hops).

    x: [C, N]. Returns [C, chunk_hops, window_size] with zero padding outside
    the signal (reference AudioPV.cpp:52-65; frames are centered so the first
    window starts at -window_size/2).
    """
    n = x.shape[-1]
    # hop*i - window/2 + k for i in chunk, k in window
    starts = (start_hop + jnp.arange(chunk_hops)) * hop - window_size // 2
    idx = starts[:, None] + jnp.arange(window_size)[None, :]
    valid = (idx >= 0) & (idx < n)
    gathered = jnp.take(x, jnp.clip(idx, 0, n - 1), axis=-1)
    return jnp.where(valid[None], gathered, 0.0)


def _wrap_radians(x):
    """Wrap to [-pi, pi] (reference phase_vocoder.cpp:38-41)."""
    return x - 2.0 * jnp.pi * jnp.round(x / (2.0 * jnp.pi))


_TRI_BLOCK = 256

def rfft_mag_phase(x: jnp.ndarray, n: int):
    """(|X|, arg X) of the real FFT of x [..., m] padded to n."""
    spec = jnp.fft.rfft(x, n=n, axis=-1)
    re, im = jnp.real(spec), jnp.imag(spec)
    # forward-exact, gradient-safe polar extraction: sqrt/atan2 have NaN
    # grads at (0, 0) (all-zero frames); dead points route through
    # dummies (atan2(0, 1) = 0 = IEEE atan2(0, 0), so values are equal).
    # atan2 is the polynomial form (ops/fastmath.py), which beat
    # jnp.arctan2 end to end in the stretch pipeline; its ~1.5e-7 rad
    # error is ~9e-6 Hz at the default analysis rate.
    from flan_tpu.ops.fastmath import atan2 as _fast_atan2
    energy = re * re + im * im
    dead = energy == 0.0
    mag = jnp.where(dead, 0.0,
                    jnp.sqrt(jnp.where(dead, 1.0, energy))).astype(
        jnp.float32)
    phase = _fast_atan2(jnp.where(dead, 0.0, im),
                        jnp.where(dead, 1.0, re)).astype(jnp.float32)
    return mag, phase


def irfft_polar(mag: jnp.ndarray, phase: jnp.ndarray, n: int):
    """Inverse real FFT of mag * exp(i phase) [..., n//2+1] -> [..., n].

    The DC and (even n) Nyquist bins of a real signal's spectrum are
    real, but the accumulated phase gives them imaginary parts. FFTW's
    c2r (the reference's), numpy's and XLA's CPU FFT ignore those parts;
    cuFFT's batched c2r does not (on an H100, a batch of 256 4096-point
    transforms moved by up to 1.1e-3 with them, a single transform not
    at all). Zeroing them gives every backend the reference's result and
    leaves the CPU's output bit for bit unchanged."""
    real_bins = np.zeros(n // 2 + 1, bool)
    real_bins[0] = True
    real_bins[-1] = n % 2 == 0
    re = mag * jnp.cos(phase)
    im = jnp.where(real_bins, 0.0, mag * jnp.sin(phase))
    return jnp.fft.irfft(jax.lax.complex(re, im), n=n, axis=-1)


def cumsum_mod1_frames(inc: jnp.ndarray) -> jnp.ndarray:
    """Inclusive mod-1 cumsum along axis 1 of [C, F, B], as matmuls.

    The phase accumulator is the hot reduction of every inverse transform.
    A log-depth scan moves the full array ~log2(F) times through device
    memory; here the within-block prefix is one lower-triangular matmul
    (256-wide) and blocks are chained with a tiny cross-block prefix, so
    the array moves ~3x total. Values stay bounded by the block length, so
    float32 keeps phase error below 2^-24 * block cycles.
    """
    c, f, b = inc.shape
    blk = _TRI_BLOCK
    fpad = _cdiv(f, blk) * blk
    if fpad != f:
        inc = jnp.pad(inc, [(0, 0), (0, fpad - f), (0, 0)])
    nb = fpad // blk
    x = inc.reshape(c, nb, blk, b)
    tri = jnp.asarray(
        np.tril(np.ones((blk, blk), np.float32)))       # [g, f], f <= g
    # HIGHEST: the reduced-precision default (TF32 on GPUs) would round the
    # f32 cycle increments to ~1e-3 cycle phase error.
    within = jnp.einsum("gf,cnfb->cngb", tri, x,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    totals = jnp.mod(within[:, :, -1, :], 1.0)           # [C, nb, B]
    # exclusive cross-block mod-1 prefix (nb is small)
    prefix = jax.lax.associative_scan(
        lambda p, q: jnp.mod(p + q, 1.0), totals, axis=1)
    prefix = jnp.concatenate(
        [jnp.zeros((c, 1, b), jnp.float32), prefix[:, :-1]], axis=1)
    out = jnp.mod(within + prefix[:, :, None, :], 1.0)
    return out.reshape(c, fpad, b)[:, :f]


@functools.partial(
    jax.jit,
    static_argnames=("window_size", "hop", "dft_size", "sample_rate",
                     "chunk_hops"))
def pv_forward(x: jnp.ndarray, *, window_size: int = 2048, hop: int = 128,
               dft_size: int = 4096, sample_rate: float = 48000.0,
               chunk_hops: int = 2048):
    """Audio [C, N] -> (mag, freq) each [C, num_hops, dft/2+1].

    Matches reference Audio::convert_to_PV (AudioPV.cpp:12-78): hann analysis
    window of window_size, zero-padded to dft_size, r2c FFT, per-bin phase
    vocoding with zero initial phase.
    """
    c, n = x.shape
    nh = num_hops(n, hop)
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop

    window = hann_window(window_size)
    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / dft_size))
    # expected phase advance per hop, in radians (phase_vocoder.cpp:47)
    expected = bin_freq / analysis_rate * (2.0 * jnp.pi)

    chunk = min(chunk_hops, nh)
    nchunks = _cdiv(nh, chunk)

    def body(prev_phase, start):
        framed = _frame_signal(x, start, chunk, hop, window_size)
        framed = framed * window[None, None, :]
        mag, phase = rfft_mag_phase(framed, dft_size)  # [C, chunk, B]
        prev = jnp.concatenate([prev_phase[:, None, :], phase[:, :-1, :]],
                               axis=1)
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (analysis_rate
                                                  / (2.0 * jnp.pi))
        return phase[:, -1, :], (mag, freq.astype(jnp.float32))

    starts = jnp.arange(nchunks) * chunk
    init_phase = jnp.zeros((c, nbins), jnp.float32)
    _, (mags, freqs) = jax.lax.scan(body, init_phase, starts)
    # [nchunks, C, chunk, B] -> [C, nchunks*chunk, B] -> trim to nh
    mags = mags.transpose(1, 0, 2, 3).reshape(c, nchunks * chunk, nbins)
    freqs = freqs.transpose(1, 0, 2, 3).reshape(c, nchunks * chunk, nbins)
    return mags[:, :nh], freqs[:, :nh]


@functools.partial(
    jax.jit,
    static_argnames=("window_size", "hop", "sample_rate", "chunk_hops"))
def pv_inverse(mag: jnp.ndarray, freq: jnp.ndarray, *,
               window_size: int = 2048, hop: int = 128,
               sample_rate: float = 48000.0, chunk_hops: int = 2048):
    """(mag, freq) [C, F, B] -> audio [C, F * hop].

    Matches reference PV::convert_to_audio (AudioPV.cpp:86-139): per-bin
    phase accumulation of freq / analysis_rate revolutions per frame, c2r
    FFT, overlap-add with a hann window scaled by the reference's empirical
    2.67 round-trip gain constant (AudioPV.cpp:99).
    """
    c, f, nbins = mag.shape
    dft_size = 2 * (nbins - 1)
    analysis_rate = sample_rate / hop
    out_frames = f * hop

    # window padded to a hop multiple so overlap-add is pure reshapes
    wpad = _cdiv(window_size, hop) * hop
    r = wpad // hop  # number of hop-blocks per window
    # The reference scale (AudioPV.cpp:99) assumes FFTW's unnormalized c2r;
    # jnp.fft.irfft divides by dft_size, so fold that back in.
    window_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    window = jnp.zeros((wpad,), jnp.float32).at[:window_size].set(
        hann_window(window_size) * window_scale)

    chunk = min(chunk_hops, f)
    nchunks = _cdiv(f, chunk)
    fpad = nchunks * chunk
    if fpad != f:
        pad = [(0, 0), (0, fpad - f), (0, 0)]
        mag = jnp.pad(mag, pad)
        freq = jnp.pad(freq, pad)

    # [nchunks, C, chunk, B] views for scan
    mag_s = mag.reshape(c, nchunks, chunk, nbins).transpose(1, 0, 2, 3)
    freq_s = freq.reshape(c, nchunks, chunk, nbins).transpose(1, 0, 2, 3)

    def body(carry, inputs):
        cycle0, tail = carry  # cycle0: [C, B] mod-1 offset; tail: [C, r, hop]
        m, fr = inputs
        # inclusive prefix-sum of cycles, everything mod 1
        inc = jnp.mod(fr / analysis_rate, 1.0)
        cycles = cumsum_mod1_frames(inc)
        cycles = jnp.mod(cycles + cycle0[:, None, :], 1.0)
        phase = cycles * (2.0 * jnp.pi)
        frames = irfft_polar(m, phase, dft_size)[..., :wpad]
        frames = frames * window[None, None, :]
        # overlap-add: r diagonal sums over hop-blocks
        blocks = frames.reshape(c, chunk, r, hop)
        acc = jnp.zeros((c, chunk + r, hop), jnp.float32)
        acc = acc.at[:, :r, :].set(tail)
        for j in range(r):
            acc = acc.at[:, j:j + chunk, :].add(blocks[:, :, j, :])
        out = acc[:, :chunk, :]
        new_tail = acc[:, chunk:, :]
        return (cycles[:, -1, :], new_tail), out

    init = (jnp.zeros((c, nbins), jnp.float32),
            jnp.zeros((c, r, hop), jnp.float32))
    (_, tail), outs = jax.lax.scan(body, init, (mag_s, freq_s))
    # outs: [nchunks, C, chunk, hop] -> [C, fpad*hop]; append final tail
    body_audio = outs.transpose(1, 0, 2, 3).reshape(c, fpad * hop)
    tail_audio = tail.reshape(c, r * hop)
    audio = jnp.concatenate([body_audio, tail_audio], axis=-1)
    # Block a of the accumulated stream holds output [hop*a - window/2,
    # hop*a - window/2 + hop), so output frame 0 sits at stream position
    # window/2 (the reference clamps these leading frames away,
    # AudioPV.cpp:127).
    shift = window_size // 2
    return audio[:, shift:shift + out_frames]
