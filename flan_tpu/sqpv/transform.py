"""Audio <-> SQPV conversions: the sliding constant-Q transform, activated.

The reference ships this algorithm written but commented out
(reference: src/flan/Conversions/AudioSQPV.cpp:1-170, following "Sliding
With A Constant-Q", DAFx-08). Per bin k with period N_k = ceil(Q*sr/f_k)
and twiddles a_{k,j} = exp(i*2pi*(Q+j)/N_k), j in {-1,0,+1}, it runs the
per-sample recurrence

    F_j[t] = a_{k,j} * ( F_j[t-1] + (fiddle * x[t+N_k/2] - x[t-N_k/2])/N_k )

then hann-windows spectrally (0.5*F_0 - 0.25*(F_-1 + F_+1)) and phase
vocodes at analysis_rate == sample_rate.

Parallel formulation: the recurrence has |a| == 1, so each chunk of L
frames is one modulated prefix sum,

    F[j] = a^(j+1) * ( F_prev + sum_{i<=j} a^(-i) u[i] ),   j in [0, L)

with the inner cumsum as a lower-triangular matmul and the a^(-i) /
a^(j+1) tables host-precomputed in float64 (they depend only on the local
index, so no table grows with signal length and only the per-chunk carry
accumulates rounding). The comb operand stages once as B static shifted
slices of the padded signal (O(n x bins) device memory - the same order
as the transform's own output; per-chunk gathers were slower where
measured before). The reference's implicit float->int
truncation of the half-period sample offsets (AudioSQPV.cpp:100-103:
frame +- N_k/2.0f passed to an integer-argument lambda) is reproduced
exactly by the padding + the per-chunk quirk mask.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# frames per scan step, inherited from the previous accelerator's sweep;
# re-sweeping on the card is an open question
_CHUNK = 1024


def _cq_params(sample_rate: float, bins_per_octave: float,
               bandwidth: Tuple[float, float]):
    """Host-side constant-Q geometry (reference SQPVBuffer.cpp:17-31)."""
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lo_pitch = math.log2(bandwidth[0])
    hi_pitch = math.log2(bandwidth[1])
    nbins = int(math.ceil((hi_pitch - lo_pitch) * bins_per_octave))
    freqs = 2.0 ** (np.arange(nbins) / bins_per_octave + lo_pitch)
    periods = np.ceil(q * sample_rate / freqs).astype(np.int64)
    return q, nbins, freqs, periods


def _stage_comb(x, sample_rate: float, bins_per_octave: float,
                bandwidth: Tuple[float, float], tile: int):
    """Stage the comb operand u[c, t, b] = (fiddle*x[t+P_b] - x[t-M_b])/N_b
    for the whole padded timeline as B static shifted slices of the
    zero-padded signal (plain memcpys, contiguous over bins; see the
    module docstring). The reference's toward-zero trunc quirk
    (AudioSQPV.cpp:100-103) — one x[0] read per odd-period bin/side — is
    folded in as a host-indexed scatter (mode='drop' replicates the
    scan-window bound: positions beyond the padded timeline never fire).

    Returns (u_re, u_im, w0, nbins) with the time axis padded to a
    multiple of `tile`. Traced — call inside jit.
    """
    c, n = x.shape
    q, nbins, freqs, periods = _cq_params(sample_rate, bins_per_octave,
                                          bandwidth)
    # warmup: the reference starts each bin at floor(-N_k/2 - 1)
    # (AudioSQPV.cpp:98); u is exactly zero before the window slides in,
    # so one global start at the earliest bin is identical.
    w0 = int(periods.max() // 2 + 2)
    total = w0 + n
    tpad = -(-total // tile) * tile

    fiddle = np.exp(-1j * 2.0 * np.pi * q)  # AudioSQPV.cpp:82
    fr, fi = float(fiddle.real), float(fiddle.imag)
    off_p_np = (periods // 2).astype(np.int64)
    off_m_np = ((periods + 1) // 2).astype(np.int64)
    pad_l = w0 + int(off_m_np.max())
    pad_r = max(0, tpad - w0 + int(off_p_np.max()) - n + 1)
    xq = jnp.pad(x, [(0, 0), (pad_l, pad_r)])

    base = pad_l - w0  # xq index of global t = 0 minus w0 shift
    x0 = x[:, 0]
    urs, uis = [], []
    for b in range(nbins):
        s_new = base + int(off_p_np[b])
        s_old = base - int(off_m_np[b])
        new_b = jax.lax.slice(xq, (0, s_new), (c, s_new + tpad))
        old_b = jax.lax.slice(xq, (0, s_old), (c, s_old + tpad))
        scale = float(1.0 / periods[b])
        u_re_b = (fr * new_b - old_b) * scale
        u_im_b = (fi * new_b) * scale
        # trunc quirk: the lone t = -M_b (plus side) / t = P_b (minus
        # side) sample per odd-period bin truncating -0.5 -> index 0
        # reads x[0]. It is applied per slice, before the stack: a
        # scatter on the stacked array breaks XLA's fusion of the slices
        # into the concat buffer and materializes every slice as its own
        # temporary.
        if periods[b] % 2 == 1:
            t_new = w0 - int(off_m_np[b])
            t_old = w0 + int(off_p_np[b])
            u_re_b = u_re_b.at[:, t_new].add(x0 * np.float32(fr * scale))
            u_im_b = u_im_b.at[:, t_new].add(x0 * np.float32(fi * scale))
            if t_old < tpad:
                u_re_b = u_re_b.at[:, t_old].add(x0 * np.float32(-scale))
        urs.append(u_re_b)
        uis.append(u_im_b)
    u_re = jnp.stack(urs, axis=-1)
    u_im = jnp.stack(uis, axis=-1)
    return u_re, u_im, w0, nbins


@functools.partial(jax.jit, static_argnames=(
    "sample_rate", "bins_per_octave", "bandwidth", "chunk",
    "cumsum_precision"))
def _sqpv_forward_scan(x, *, sample_rate: float, bins_per_octave: float,
                       bandwidth: Tuple[float, float], chunk: int = _CHUNK,
                       cumsum_precision=jax.lax.Precision.HIGHEST):
    from flan_tpu.ops.stft import _wrap_radians
    from flan_tpu.spv.spv import _cumsum_frames_tri
    c, n = x.shape
    L = chunk
    q, nbins, freqs, periods = _cq_params(sample_rate, bins_per_octave,
                                          bandwidth)
    u_re_full, u_im_full, w0, nbins = _stage_comb(
        x, sample_rate, bins_per_octave, bandwidth, tile=L)
    tpad = u_re_full.shape[1]
    nchunks = tpad // L

    # host tables (float64 -> float32): local-index twiddle powers.
    # LAYOUT: the three spectral-hann twiddle lines live on a LEADING
    # axis [3, L, B]: a trailing [..., B, 3] would put the size-3 axis
    # innermost, behind every elementwise op.
    jv = np.array([-1.0, 0.0, 1.0])
    theta = 2.0 * np.pi * (q + jv[:, None]) / periods[None, :]  # [3, B]
    i_loc = np.arange(L, dtype=np.float64)
    t1 = np.exp(-1j * i_loc[None, :, None] * theta[:, None, :])  # a^{-i}
    t2 = np.exp(1j * (i_loc + 1.0)[None, :, None] * theta[:, None, :])
    t1_re = jnp.asarray(t1.real, jnp.float32)    # [3, L, B]
    t1_im = jnp.asarray(t1.imag, jnp.float32)
    t2_re = jnp.asarray(t2.real, jnp.float32)
    t2_im = jnp.asarray(t2.imag, jnp.float32)

    bin_freq = jnp.asarray(freqs, jnp.float32)
    expected = bin_freq / sample_rate * (2.0 * jnp.pi)

    def cumsum_l(v):  # [C, L, B*3] inclusive cumsum over axis 1 (matmul)
        return _cumsum_frames_tri(v, precision=cumsum_precision)

    def body(carry, t0):
        f_re, f_im, prev_phase = carry  # [3, C, B], [3, C, B], [C, B]
        u_re = jax.lax.dynamic_slice(u_re_full, (0, t0, 0),
                                     (c, L, nbins))      # [C, L, B]
        u_im = jax.lax.dynamic_slice(u_im_full, (0, t0, 0), (c, L, nbins))

        # v = a^{-i} * u over the three twiddle lines (leading axis)
        v_re = u_re[None] * t1_re[:, None] - u_im[None] * t1_im[:, None]
        v_im = u_re[None] * t1_im[:, None] + u_im[None] * t1_re[:, None]
        s_re = cumsum_l(v_re.reshape(3 * c, L, nbins)).reshape(v_re.shape)
        s_im = cumsum_l(v_im.reshape(3 * c, L, nbins)).reshape(v_im.shape)
        s_re = s_re + f_re[:, :, None]                   # [3, C, L, B]
        s_im = s_im + f_im[:, :, None]
        # F = a^{j+1} * (F_prev + cumsum)
        F_re = s_re * t2_re[:, None] - s_im * t2_im[:, None]
        F_im = s_re * t2_im[:, None] + s_im * t2_re[:, None]

        # spectral hann window (AudioSQPV.cpp:110-112):
        # 0.5 * F_0 - 0.25 * (F_-1 + F_+1)
        fw_re = 0.5 * F_re[1] - 0.25 * (F_re[0] + F_re[2])
        fw_im = 0.5 * F_im[1] - 0.25 * (F_im[0] + F_im[2])

        from flan_tpu.ops.fastmath import atan2 as _fast_atan2
        mag = jnp.sqrt(fw_re * fw_re + fw_im * fw_im)
        phase = _fast_atan2(fw_im, fw_re)
        prev = jnp.concatenate([prev_phase[:, None, :], phase[:, :-1]],
                               axis=1)
        # analysis_rate == sample_rate, so the reference skips wrapping
        # (phase_vocoder.cpp:37); as in spv.py we wrap deliberately so that
        # +-pi boundary crossings don't alias under pitch arithmetic.
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (sample_rate
                                                  / (2.0 * jnp.pi))

        new_carry = (F_re[:, :, -1], F_im[:, :, -1], phase[:, -1])
        return new_carry, (mag.astype(jnp.float32),
                           freq.astype(jnp.float32))

    init = (jnp.zeros((3, c, nbins), jnp.float32),
            jnp.zeros((3, c, nbins), jnp.float32),
            jnp.zeros((c, nbins), jnp.float32))
    t0s = (jnp.arange(nchunks) * L).astype(jnp.int32)
    _, (mags, freqs_out) = jax.lax.scan(body, init, t0s)
    mags = mags.transpose(1, 0, 2, 3).reshape(c, tpad, nbins)
    freqs_out = freqs_out.transpose(1, 0, 2, 3).reshape(c, tpad, nbins)
    mag = mags[:, w0:w0 + n]
    freq = freqs_out[:, w0:w0 + n]
    pitch = jnp.log2(jnp.maximum(jnp.abs(freq), 1e-12))
    positive = freq >= 0
    return mag, pitch, positive


def sqpv_forward(x: jnp.ndarray, sample_rate: float,
                 bins_per_octave: float,
                 bandwidth: Tuple[float, float], chunk: int = _CHUNK,
                 cumsum_precision=jax.lax.Precision.HIGHEST):
    """Audio [C, N] -> (mag, pitch, positive) each [C, N, B]."""
    return _sqpv_forward_scan(
        x, sample_rate=float(sample_rate),
        bins_per_octave=float(bins_per_octave),
        bandwidth=(float(bandwidth[0]), float(bandwidth[1])),
        chunk=chunk, cumsum_precision=cumsum_precision)


@functools.partial(jax.jit, static_argnames=(
    "sample_rate", "bins_per_octave", "bandwidth", "chunk"))
def _sqpv_inverse_scan(mag, pitch, positive, *, sample_rate: float,
                       bins_per_octave: float,
                       bandwidth: Tuple[float, float], chunk: int = _CHUNK):
    from flan_tpu.ops.stft import cumsum_mod1_frames
    c, f, b = mag.shape
    q, nbins, freqs, periods = _cq_params(sample_rate, bins_per_octave,
                                          bandwidth)
    assert b == nbins, (b, nbins)
    # synthesis rotation (AudioSQPV.cpp:133): exp(i*2pi*Q/N_k)
    tw = np.exp(1j * 2.0 * np.pi * q / periods.astype(np.float64))
    tw_re = jnp.asarray(tw.real, jnp.float32)
    tw_im = jnp.asarray(tw.imag, jnp.float32)

    nchunks = -(-f // chunk)
    fpad = nchunks * chunk
    if fpad != f:
        mag = jnp.pad(mag, [(0, 0), (0, fpad - f), (0, 0)])
        pitch = jnp.pad(pitch, [(0, 0), (0, fpad - f), (0, 0)])
        positive = jnp.pad(positive, [(0, 0), (0, fpad - f), (0, 0)])
    sign = jnp.where(positive, 1.0, -1.0).astype(jnp.float32)
    freq = sign * jnp.exp2(pitch)
    mag_s = mag.reshape(c, nchunks, chunk, b).transpose(1, 0, 2, 3)
    freq_s = freq.reshape(c, nchunks, chunk, b).transpose(1, 0, 2, 3)

    def body(cycle0, inputs):
        m, fr = inputs
        inc = jnp.mod(fr / sample_rate, 1.0)
        cycles = jnp.mod(cumsum_mod1_frames(inc) + cycle0[:, None, :], 1.0)
        ang = cycles * (2.0 * jnp.pi)
        # Re( polar(m, phase) * twiddle_k ), summed over bins
        out = jnp.sum(m * (jnp.cos(ang) * tw_re[None, None, :]
                           - jnp.sin(ang) * tw_im[None, None, :]), axis=-1)
        return cycles[:, -1, :], out.astype(jnp.float32)

    init = jnp.zeros((c, b), jnp.float32)
    _, outs = jax.lax.scan(body, init, (mag_s, freq_s))
    return outs.transpose(1, 0, 2).reshape(c, fpad)[:, :f]


def sqpv_inverse(mag, pitch, positive, sample_rate: float,
                 bins_per_octave: float,
                 bandwidth: Tuple[float, float]) -> jnp.ndarray:
    """(mag, pitch, positive) [C, F, B] -> audio [C, F]
    (reference AudioSQPV.cpp:128-165): per-bin phase accumulation of the
    pitch-decoded frequencies, then the twiddle-rotated real-part sum."""
    return _sqpv_inverse_scan(
        mag, pitch, positive, sample_rate=float(sample_rate),
        bins_per_octave=float(bins_per_octave),
        bandwidth=(float(bandwidth[0]), float(bandwidth[1])))
