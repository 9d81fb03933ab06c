"""Audio information: pitch tracking, envelopes.

JAX re-design of the reference information family
(reference: src/flan/Audio/AudioInformation.cpp). The YIN-style wavelength
search runs batched over all hops; the octave-flicker continuity pass stays
on host (tiny control data). Attached to Audio in flan_tpu.audio.__init__.
"""
from __future__ import annotations

import math
from typing import List

import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import Function
from flan_tpu.ops.dsp_utility import (select_wavelength_batched,
                                      yin_d_prime_batched)
from flan_tpu.ops.windows import hann_window


def get_local_wavelength(self, channel: int, start: int,
                         window_size: int = 2048,
                         absolute_cutoff: float = 0.2,
                         minimum_wavelength: int = 10) -> float:
    """(reference AudioInformation.cpp:138-166)"""
    if self.is_null():
        return 0.0
    w = self.data[channel, start:start + window_size]
    if w.shape[0] < window_size:
        w = jnp.pad(w, (0, window_size - w.shape[0]))
    dp = yin_d_prime_batched(w[None, :], window_size=window_size)
    wl = select_wavelength_batched(
        dp, absolute_cutoff=absolute_cutoff,
        minimum_wavelength=minimum_wavelength)
    return float(wl[0])


def get_local_wavelengths(self, channel: int, start: int = 0, end: int = -1,
                          window_size: int = 2048, hop: int = 128,
                          absolute_cutoff: float = 0.2,
                          minimum_wavelength: int = 10) -> np.ndarray:
    """Per-hop wavelengths with octave-flicker continuity maintenance
    (reference AudioInformation.cpp:168-229)."""
    if self.is_null():
        return np.zeros((0,), np.float32)
    if end == -1:
        end = self.num_frames
    starts = np.arange(start, max(start, end - window_size), hop)
    if len(starts) == 0:
        return np.zeros((0,), np.float32)

    idx = starts[:, None] + np.arange(window_size)[None, :]
    windows = jnp.take(self.data[channel],
                       jnp.asarray(np.clip(idx, 0, self.num_frames - 1)),
                       axis=0)
    windows = jnp.where(jnp.asarray(idx < self.num_frames), windows, 0.0)
    dp = yin_d_prime_batched(windows, window_size=window_size)
    out = np.asarray(select_wavelength_batched(
        dp, absolute_cutoff=absolute_cutoff,
        minimum_wavelength=minimum_wavelength), np.float64)

    # Continuity maintenance: short octave-up jumps are folded back down
    # (reference AudioInformation.cpp:190-226).
    minimum_note_length = 0.1
    min_hops = int(self.time_to_frame(minimum_note_length) / hop)
    sus = []
    for i in range(len(out) - 1):
        if out[i] == 0:
            continue
        r = out[i + 1] / out[i]
        if 1.95 < r < 2.05:
            sus.append(i + 1)
    for h in sus:
        sus_len = 0
        while sus_len <= min_hops:
            g = h + sus_len
            if g >= len(out):
                break
            if out[g] != 0:
                r = out[g] / out[h]
                if r < 0.95 or r > 1.05:
                    break
            sus_len += 1
        if sus_len > min_hops:
            break
        out[h:h + sus_len] /= 2.0
    return out.astype(np.float32)


def get_average_wavelength(self, locals_or_channel, min_active_ratio=0.0,
                           max_length_sigma=-1.0, start=0, end=-1,
                           window_size=2048, hop=128) -> float:
    """(reference AudioInformation.cpp:231-265)"""
    if self.is_null():
        return 0.0
    if isinstance(locals_or_channel, (int, np.integer)):
        locals_ = get_local_wavelengths(self, locals_or_channel, start, end,
                                        window_size, hop)
    else:
        locals_ = np.asarray(locals_or_channel)
    num_valid = int((locals_ != -1).sum())
    if num_valid <= min_active_ratio * len(locals_):
        return -1.0
    valid = locals_[locals_ != 0]
    if len(valid) == 0:
        return -1.0
    m, sd = float(valid.mean()), float(valid.std())
    if max_length_sigma != -1 and sd > max_length_sigma:
        return -1.0
    return m


def get_local_frequency(self, channel: int, start: int = 0,
                        window_size: int = 2048) -> float:
    """(reference AudioInformation.cpp:267-294)"""
    wl = get_local_wavelength(self, channel, start, window_size, 0.2, 10)
    return self.sample_rate / wl if wl > 0 else 0.0


def get_local_frequencies(self, channel: int, start: int = 0, end: int = -1,
                          window_size: int = 2048, hop: int = 128
                          ) -> np.ndarray:
    """(reference AudioInformation.cpp:296-318)"""
    wl = get_local_wavelengths(self, channel, start, end, window_size, hop,
                               0.2, 10)
    out = np.where(wl != 0, self.sample_rate / np.where(wl != 0, wl, 1.0),
                   0.0)
    return out.astype(np.float32)


def get_amplitude_envelope(self, window_width: float = 0.1) -> Function:
    """Rectify + hann smoothing convolution, pi/2 compensation
    (reference AudioInformation.cpp:320-363)."""
    if self.is_null() or window_width <= 0:
        return Function(0.0)
    mono = self.convert_to_mono()
    rectified = jnp.abs(mono.data[0])
    from flan_tpu.core.types import power_of_2_container
    wframes = int(self.time_to_frame(window_width))
    win = hann_window(max(wframes, 2))
    integral = float(jnp.sum(win))
    n = rectified.shape[0] + wframes
    dft = 2 * power_of_2_container(max(rectified.shape[0], wframes))
    spec = (jnp.fft.rfft(rectified, n=dft)
            * jnp.fft.rfft(win, n=dft))
    env = jnp.fft.irfft(spec, n=dft)[:n] * (math.pi / 2.0 / integral)
    ys = env
    sr = self.sample_rate
    size = int(n)

    def fn(t):
        x = jnp.asarray(t) * sr
        x1 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, size - 2)
        y1 = ys[x1]
        y2 = ys[x1 + 1]
        out = y1 + (y2 - y1) * (x - x1)
        return jnp.where((x >= 0) & (x < size - 1), out, 0.0)

    return Function(fn)


def get_frequency_envelope(self) -> Function:
    """Lerped local frequencies (reference AudioInformation.cpp:388-407)."""
    hop = 128
    freqs = jnp.asarray(
        get_local_frequencies(self.convert_to_mono(), 0, 0, -1, 2048, hop))
    if freqs.shape[0] == 0:
        return Function(0.0)
    sr = self.sample_rate
    size = int(freqs.shape[0])

    def fn(t):
        x = jnp.asarray(t) * sr / hop
        x1 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, max(size - 2, 0))
        y1 = freqs[x1]
        y2 = freqs[jnp.minimum(x1 + 1, size - 1)]
        out = y1 + (y2 - y1) * (x - x1)
        return jnp.where((x >= 0) & (x < size - 1), out, 0.0)

    return Function(fn)
