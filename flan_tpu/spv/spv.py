"""SPV: sliding-DFT phase vocoder (one spectral frame per audio sample).

JAX re-design of the reference SPV type
(reference: src/flan/SPV/SPVBuffer.h, SPV.cpp, Conversions/AudioSPV.cpp).
The reference already discovered the prefix-sum form of the sliding DFT
(AudioSPV.cpp:54-59); here the per-bin sequential sums become one cumsum
over the frame axis, the 3-tap hann spectral convolution is a vectorized
stencil, and phase vocoding reuses the batched lag-1-diff / mod-1-scan
machinery. Analysis rate equals the sample rate, so no phase wrapping is
needed (phase_vocoder.cpp:37).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import as_function2d


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SPV:
    """Per-sample spectral data, SoA mag/freq [C, F, B]."""
    mag: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    freq: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    sample_rate: float = dataclasses.field(
        default=48000.0, metadata=dict(static=True))

    # --- Info (reference SPVBuffer.h) ---------------------------------------
    @property
    def num_channels(self) -> int:
        return int(self.mag.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.mag.shape[1])

    @property
    def num_bins(self) -> int:
        return int(self.mag.shape[2])

    @property
    def analysis_rate(self) -> float:
        return self.sample_rate

    @property
    def bin_width(self) -> float:
        return self.sample_rate / (2 * self.num_bins)

    def bin_to_frequency(self, b) -> float:
        return b * self.bin_width

    def frequency_to_bin(self, f) -> float:
        return f / self.bin_width

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    def _with(self, **kwargs) -> "SPV":
        return dataclasses.replace(self, **kwargs)

    def copy(self) -> "SPV":
        return self._with()

    @staticmethod
    def create_null() -> "SPV":
        return SPV()

    # --- Algorithms (reference SPV.cpp:21-44) -------------------------------
    def modify_frequency(self, mod) -> "SPV":
        """Map each MF's frequency through mod(t, f)."""
        if self.is_null():
            return SPV.create_null()
        fn = as_function2d(mod)
        t = jnp.arange(self.num_frames,
                       dtype=jnp.float32)[None, :, None] / self.sample_rate
        tt = jnp.broadcast_to(t, self.freq.shape)
        new_freq = jnp.broadcast_to(
            jnp.asarray(fn(tt, self.freq), jnp.float32), self.freq.shape)
        return self._with(freq=new_freq)

    def repitch(self, factor) -> "SPV":
        fn = as_function2d(factor)
        return self.modify_frequency(lambda t, f: f * fn(t, f))

    # --- Conversions (reference AudioSPV.cpp:113-150) -----------------------
    def convert_to_audio(self):
        from flan_tpu.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        data = spv_inverse(self.mag, self.freq, self.sample_rate)
        return Audio(data=data, sample_rate=self.sample_rate)

    def convert_to_lr_audio(self):
        return self.convert_to_audio().convert_to_left_right()


def _twiddle_table_np(nbins: int):
    """One period of e^{-i pi j b / B}: rows j in [0, 2B), bins b in [0, B),
    with exact integer phase reduction mod 2B (the reference indexes a 2B
    twiddle table, AudioSPV.cpp:13-38). Returns (re, im) float32 [2B, B]."""
    two_b = 2 * nbins
    j = np.arange(two_b, dtype=np.int64)
    b = np.arange(nbins, dtype=np.int64)
    idx = (j[:, None] * b[None, :]) % two_b
    ang = -2.0 * np.pi / two_b * idx.astype(np.float64)
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _cumsum_frames_tri(x: jnp.ndarray, block: int = 128,
                       precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Inclusive cumsum along axis 1 of [C, T, B], two-level matmul form.

    Within 128-frame blocks the prefix is one lower-triangular [128, 128]
    matmul; blocks chain through a tiny exclusive
    prefix of their totals. Per-sample matmul work is `block` MACs
    regardless of chunk size, so the streaming chunk can grow (fewer scan
    carries) without quadratic cumsum cost — the single-level form paid
    `chunk` MACs/sample."""
    c, t, b = x.shape
    if t <= block:
        tri = jnp.asarray(np.tril(np.ones((t, t), np.float32)))
        return jnp.einsum("gf,cfb->cgb", tri, x,
                          preferred_element_type=jnp.float32,
                          precision=precision)
    assert t % block == 0, (t, block)
    nb = t // block
    xb = x.reshape(c, nb, block, b)
    tri = jnp.asarray(np.tril(np.ones((block, block), np.float32)))
    inner = jnp.einsum("gf,cnfb->cngb", tri, xb,
                       preferred_element_type=jnp.float32,
                       precision=precision)
    totals = inner[:, :, -1, :]                       # [C, nb, B]
    offs = jnp.cumsum(totals, axis=1) - totals        # exclusive prefix
    return (inner + offs[:, :, None, :]).reshape(c, t, b)


# HIGH is TF32 on a GPU. The cumsum operands are bounded amplitudes, not
# phase, and the aligned round-trip SNR sits at the transform's own floor
# either way: 31.6 dB at HIGH vs 31.1 dB at HIGHEST, with the 30 s mono
# 512-bin round trip at 284x vs 266x realtime (NVIDIA H100 80GB HBM3,
# 700 W). The 1024-frame chunk is inherited; re-sweeping it on the card
# is an open question.
_SPV_CHUNK = 1024
_SPV_PRECISION = jax.lax.Precision.HIGH


@functools.partial(jax.jit, static_argnames=("nbins", "sample_rate",
                                             "chunk", "cumsum_precision"))
def _spv_forward_scan(x, *, nbins: int, sample_rate: float,
                      chunk: int = _SPV_CHUNK,
                      cumsum_precision=_SPV_PRECISION):
    """Streaming sliding-DFT forward: peak HBM O(chunk x bins), not O(N x B).

    The naive form materializes [C, N, B] complex contributions twice -
    ~23 GB for 60 s mono at 513 bins. Here one
    lax.scan carries only the running complex sum and the previous frame's
    phase; everything is kept in separate re/im float32 planes (large 1-D
    complex ops are shaky on this backend).
    """
    from flan_tpu.ops.stft import _wrap_radians
    c, n = x.shape
    two_b = 2 * nbins
    nchunks = -(-n // chunk)
    npad = nchunks * chunk

    # comb-filter operand: x zero-padded 2B to the left (AudioSPV.cpp:47-52)
    xp = jnp.pad(x, [(0, 0), (two_b, 0), ], constant_values=0.0)
    xp = jnp.pad(xp, [(0, 0), (0, npad - n)])

    # periodic twiddle table, tiled so any chunk is one static-length slice
    tw_re_np, tw_im_np = _twiddle_table_np(nbins)
    reps = -(-(chunk + 1) // two_b) + 1
    tw_re = jnp.asarray(np.tile(tw_re_np, (reps, 1)))
    tw_im = jnp.asarray(np.tile(tw_im_np, (reps, 1)))

    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / two_b))
    expected = bin_freq / sample_rate * (2.0 * jnp.pi)

    starts = (jnp.arange(nchunks) * chunk).astype(jnp.int32)
    offsets = jnp.asarray(
        (np.arange(nchunks, dtype=np.int64) * chunk) % two_b, jnp.int32)

    def body(carry, inputs):
        sum_re, sum_im, prev_phase = carry
        t0, off = inputs
        cur = jax.lax.dynamic_slice(xp, (0, t0 + two_b), (c, chunk))
        delayed = jax.lax.dynamic_slice(xp, (0, t0), (c, chunk))
        deltas = cur - delayed                              # [C, T]

        w_re = jax.lax.dynamic_slice(tw_re, (off, 0), (chunk, nbins))
        w_im = jax.lax.dynamic_slice(tw_im, (off, 0), (chunk, nbins))
        contrib_re = deltas[:, :, None] * w_re[None]
        contrib_im = deltas[:, :, None] * w_im[None]
        # fiddled prefix sum (AudioSPV.cpp:54-59), chained across chunks
        s_re = _cumsum_frames_tri(contrib_re, precision=cumsum_precision) \
            + sum_re[:, None, :]
        s_im = _cumsum_frames_tri(contrib_im, precision=cumsum_precision) \
            + sum_im[:, None, :]

        # rotate to the frame's reference phase: * conj(twiddle(f+1, b))
        cn_re = jax.lax.dynamic_slice(tw_re, (off + 1, 0), (chunk, nbins))
        cn_im = -jax.lax.dynamic_slice(tw_im, (off + 1, 0), (chunk, nbins))
        f_re = s_re * cn_re[None] - s_im * cn_im[None]
        f_im = s_re * cn_im[None] + s_im * cn_re[None]

        # 3-tap hann spectral convolution (AudioSPV.cpp:65-92); the edge
        # reflection uses real parts (AudioSPV.cpp:71-76, 85-90)
        def stencil(v, is_re):
            # Edge semantics golden-tested vs the compiled reference
            # (tests/test_algo_golden.py): at bin 0 BOTH neighbor taps
            # collapse to the single term 2*Re(f[1]) (AudioSPV.cpp:71-74,
            # bStart), and at bin B-1 to 2*Re(f[B-2]) (AudioSPV.cpp:85-89,
            # bEnd) - the natural complex neighbor is NOT also subtracted.
            mid = 2.0 * v
            left = jnp.pad(v, [(0, 0), (0, 0), (1, 0)])[:, :, :nbins]
            right = jnp.pad(v, [(0, 0), (0, 0), (0, 1)])[:, :, 1:]
            edge_l = 2.0 * f_re[:, :, 1] if is_re else jnp.zeros_like(
                v[:, :, 0])
            edge_r = 2.0 * f_re[:, :, -2] if is_re else jnp.zeros_like(
                v[:, :, 0])
            left = left.at[:, :, 0].set(edge_l)
            right = right.at[:, :, 0].set(0.0)
            right = right.at[:, :, -1].set(edge_r)
            left = left.at[:, :, -1].set(0.0)
            return 0.25 * (mid - left - right) / two_b

        conv_re = stencil(f_re, True)
        conv_im = stencil(f_im, False)

        # forward-exact but gradient-safe polar extraction: sqrt/atan2
        # have NaN grads at (0, 0) (zero-signal frames, e.g. the padded
        # lead-in), so zero-energy points route through dummies
        energy = conv_re * conv_re + conv_im * conv_im
        dead = energy == 0.0
        mag = jnp.where(dead, 0.0,
                        jnp.sqrt(jnp.where(dead, 1.0, energy)))
        from flan_tpu.ops.fastmath import atan2 as _fast_atan2
        phase = _fast_atan2(jnp.where(dead, 0.0, conv_im),
                            jnp.where(dead, 1.0, conv_re))
        prev = jnp.concatenate([prev_phase[:, None, :], phase[:, :-1]],
                               axis=1)
        # The reference skips wrapping when analysis_rate == sample_rate
        # (phase_vocoder.cpp:37), which leaves +-pi boundary crossings
        # encoded as freq +- sample_rate: mod-2pi-equivalent on resynthesis
        # but wrong under frequency arithmetic (repitch would scale the
        # alias). Wrapping costs nothing here - bin +- sr/2 covers the
        # whole band at ar == sr - so it is applied deliberately.
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (sample_rate
                                                  / (2.0 * jnp.pi))
        new_carry = (s_re[:, -1, :], s_im[:, -1, :], phase[:, -1, :])
        return new_carry, (mag.astype(jnp.float32),
                           freq.astype(jnp.float32))

    init = (jnp.zeros((c, nbins), jnp.float32),
            jnp.zeros((c, nbins), jnp.float32),
            jnp.zeros((c, nbins), jnp.float32))
    _, (mags, freqs) = jax.lax.scan(body, init, (starts, offsets))
    mags = mags.transpose(1, 0, 2, 3).reshape(c, npad, nbins)
    freqs = freqs.transpose(1, 0, 2, 3).reshape(c, npad, nbins)
    return mags[:, :n], freqs[:, :n]


def spv_forward(x: jnp.ndarray, nbins: int, sample_rate: float,
                chunk: int = _SPV_CHUNK,
                cumsum_precision=_SPV_PRECISION):
    """Audio [C, N] -> (mag, freq) [C, N, nbins] via sliding DFT + PV."""
    return _spv_forward_scan(x, nbins=nbins, sample_rate=float(sample_rate),
                             chunk=chunk, cumsum_precision=cumsum_precision)


@functools.partial(jax.jit, static_argnames=("sample_rate", "chunk"))
def _spv_inverse_scan(mag, freq, *, sample_rate: float,
                      chunk: int = _SPV_CHUNK):
    from flan_tpu.ops.stft import cumsum_mod1_frames
    c, f, b = mag.shape
    nchunks = -(-f // chunk)
    fpad = nchunks * chunk
    if fpad != f:
        mag = jnp.pad(mag, [(0, 0), (0, fpad - f), (0, 0)])
        freq = jnp.pad(freq, [(0, 0), (0, fpad - f), (0, 0)])
    mag_s = mag.reshape(c, nchunks, chunk, b).transpose(1, 0, 2, 3)
    freq_s = freq.reshape(c, nchunks, chunk, b).transpose(1, 0, 2, 3)
    signs = jnp.where(jnp.arange(b) % 2 == 0, 1.0, -1.0)

    def body(cycle0, inputs):
        m, fr = inputs
        inc = jnp.mod(fr / sample_rate, 1.0)
        cycles = jnp.mod(cumsum_mod1_frames(inc) + cycle0[:, None, :], 1.0)
        real = m * jnp.cos(cycles * (2.0 * jnp.pi))
        out = 2.0 * jnp.sum(real * signs[None, None, :], axis=-1)
        return cycles[:, -1, :], out.astype(jnp.float32)

    init = jnp.zeros((c, b), jnp.float32)
    _, outs = jax.lax.scan(body, init, (mag_s, freq_s))
    return outs.transpose(1, 0, 2).reshape(c, fpad)[:, :f]


def spv_inverse(mag: jnp.ndarray, freq: jnp.ndarray,
                sample_rate: float) -> jnp.ndarray:
    """(mag, freq) [C, F, B] -> audio [C, F]: accumulate phase, then the
    alternating-sign real-part sum (reference AudioSPV.cpp:113-145).
    Streams over frame chunks carrying the mod-1 cycle offset, so transient
    device memory stays O(chunk x bins)."""
    return _spv_inverse_scan(mag, freq, sample_rate=float(sample_rate))
