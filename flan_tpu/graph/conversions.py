"""Audio -> Graph and PV -> Graph conversions.

JAX re-design of the reference graph conversions
(reference: src/flan/Conversions/AudioGraph.cpp, PVGraph.cpp). Spectral
tensors (FFT magnitudes, PV value planes) are computed on device; the pixel
rendering is the host-side Graph.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from flan_tpu.core.types import power_of_2_container
from flan_tpu.graph.graph import Graph, WaveformMode
from flan_tpu.utils.geometry import Color, Interval, Rect


def _big_time_jump(w: float) -> float:
    """pow(4, floor(log2(w)/2 - 0.5)) in f32 (AudioGraph.cpp:41,
    PVGraph.cpp:40)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.power(
            np.float32(4.0),
            np.floor(np.log2(np.float32(w)) / np.float32(2)
                     - np.float32(0.5))))


def audio_convert_to_graph(self, interval=None, width: int = -1,
                           height: int = -1,
                           mode: str = WaveformMode.SYMMETRIC,
                           timeline_scale: float = 0.0) -> Graph:
    """Pixel-golden vs the compiled reference (AudioGraph.cpp:15-53):
    the interval crops the VIEW only — the waveforms are always drawn
    over the full-length rect {0,-1,length,1} (the reference computes
    start/end frames and never uses them); big ticks carry '1.000'
    labels (pow(scale_base=1, x))."""
    g = Graph(width, height)
    if self.is_null():
        return g
    if interval is None:
        interval = Interval(0.0, -1.0)
    if interval.x2 == -1:
        interval = Interval(interval.x1, self.length)
    g.fill_image(Color.from_hsv(0, 0, 0.04))
    g.add_full_split_view_y(
        Rect(interval.x1, -1.0, interval.x2, 1.0), self.num_channels)
    datas = [np.asarray(self.data[c]) for c in range(self.num_channels)]
    g.draw_waveforms(datas, Rect(0.0, -1.0, self.length, 1.0), 0, mode)
    if timeline_scale > 0:
        big = _big_time_jump(interval.w)
        g.draw_x_ticks(big / 4.0, 1.0, 1.0, int(timeline_scale / 2), 0,
                       -1, Color.from_hsv(0, 0, 0.6), 0.0)
        g.draw_x_ticks(big, 1.0, 1.0, int(timeline_scale), 0, -1,
                       Color.from_hsv(0, 0, 1.0), timeline_scale)
    return g


def audio_save_to_bmp(self, filename: str, interval=None, width: int = -1,
                      height: int = -1) -> None:
    audio_convert_to_graph(self, interval, width, height).save_image(
        filename)


def audio_convert_to_spectrum_graph(self, width: int = -1,
                                    height: int = -1,
                                    smoothing_frames: int = 128) -> Graph:
    """Log-frequency smoothed magnitude spectrum (reference
    AudioGraph.cpp:55-131): rfft magnitudes hijacked into an Audio,
    hann-convolved (normalize=true, so the pow(m/max, 0.5) scaling is a
    plain sqrt), then sampled per pixel column as a CONTINUOUS function
    bin = trunc(2^x / (sr/n)) — the bounds guard uses the CONVOLVED
    length, so bins past the raw spectrum read the smoothing tail
    (upstream quirk, AudioGraph.cpp:104-107)."""
    from flan_tpu.audio.audio import Audio
    from flan_tpu.ops.windows import hann_window
    g = Graph(width, height)
    if self.is_null():
        return g
    spectrum_log = float(np.log2(np.float32(self.sample_rate)
                                 / np.float32(2.0)))
    g.add_full_split_view_y(Rect(4.0, -0.1, spectrum_log, 1.1),
                            self.num_channels)
    g.fill_image(Color.from_hsv(0, 0, 0.05))
    g.draw_log_grid_x(1.0, 2, color=Color.from_hsv(0, 0, 0.1))
    g.draw_linear_grid_y(0.1, color=Color.from_hsv(0, 0, 0.1))
    g.draw_linear_grid_x(1.0, color=Color.from_hsv(0, 0, 0.25))

    n = power_of_2_container(self.num_frames)
    mags = jnp.abs(jnp.fft.rfft(self.data, n=n, axis=-1)
                   ).astype(jnp.float32)
    spectrum = Audio(data=mags, sample_rate=self.sample_rate)
    win = Audio(data=hann_window(max(smoothing_frames, 2))[None],
                sample_rate=self.sample_rate)
    spectrum = spectrum.convolve(win)          # normalize=true default
    max_mag = float(spectrum.get_max_sample_magnitude())
    spec = np.asarray(spectrum.data, np.float32)
    with np.errstate(invalid="ignore"):
        spec = np.power(spec / np.float32(max(max_mag, 1e-30)),
                        np.float32(0.5)).astype(np.float32)
    L = spec.shape[-1]
    div = np.float32(self.sample_rate) / np.float32(n)

    def make_cf(c):
        def f(x, _row=spec[c]):
            freq = np.power(np.float32(2.0), np.asarray(x, np.float32))
            b = np.trunc(freq / div).astype(np.int64)
            ok = (b >= 0) & (b < L)
            return np.where(ok, _row[np.clip(b, 0, L - 1)],
                            np.float32(0.0)).astype(np.float32)
        return f

    g.draw_waveforms([make_cf(c) for c in range(self.num_channels)],
                     Rect(4.0, -1.0, spectrum_log, 1.0), 0,
                     WaveformMode.DIRECT)
    g.draw_axes(color=Color.white())
    g.draw_x_ticks(1.0, 0.0, 2.0, 6, 6, -1, Color.white(), 12.0)
    return g


def audio_save_spectrum_to_bmp(self, filename: str, width: int = -1,
                               height: int = -1,
                               smoothing_frames: int = 128) -> None:
    audio_convert_to_spectrum_graph(self, width, height,
                                    smoothing_frames).save_image(filename)


def pv_convert_to_graph(self, domain=None, width: int = -1,
                        height: int = -1,
                        timeline_scale: float = 0.0) -> Graph:
    """HSV-magnitude spectrogram, pixel-golden vs the compiled
    reference (PVGraph.cpp:6-49): the value field is the CONTINUOUS
    function sqrt(|MF(trunc frames/bins)| / max) * log2(2 + freq)/4
    sampled per subsample (log2 of the subsample FREQUENCY, promoted to
    double as the reference's unqualified log2 is); the normalizing max
    runs over the domain's clamped frame/bin window EXCLUSIVE of its
    end row/column, with the end==0 -> full-range quirk
    (PVBuffer.cpp:408-426)."""
    g = Graph(width, height)
    if self.is_null():
        return g
    if domain is None:
        domain = Rect(0, 0, -1, -1)
    if domain.x2 == -1:
        domain = Rect(domain.x1, domain.y1, self.length, domain.y2)
    if domain.y2 == -1:
        # get_height() = bin_to_frequency(num_bins) — one PAST the last
        # bin (PVBuffer.cpp:391-394)
        domain = Rect(domain.x1, domain.y1, domain.x2,
                      self.bin_to_frequency(self.num_bins))
    F, B = self.num_frames, self.num_bins
    _sr = np.float32(self.sample_rate)
    _hop = np.float32(self.hop_size)
    _bw = np.float32(self.sample_rate) / np.float32(self.dft_size)
    start_frame = int(np.clip(int(np.float32(domain.x1) * _sr / _hop), 0,
                              F - 1))
    end_frame = int(np.clip(int(np.float32(domain.x2) * _sr / _hop), 0,
                            F - 1))
    start_bin = int(np.clip(int(np.float32(domain.y1) / _bw), 0, B - 1))
    end_bin = int(np.clip(int(np.float32(domain.y2) / _bw), 0, B - 1))
    if end_frame == 0:
        end_frame = F
    if end_bin == 0:
        end_bin = B
    mags = np.abs(np.asarray(self.mag, np.float32))       # [C, F, B]
    win = mags[:, start_frame:end_frame, start_bin:end_bin]
    max_mag = float(win.max()) if win.size else 0.0

    g.add_full_split_view_y(domain, self.num_channels)
    if max_mag != 0:
        sr32 = np.float32(self.sample_rate)
        hop32 = np.float32(self.hop_size)
        binw32 = np.float32(self.sample_rate) / np.float32(self.dft_size)

        def make_f(c):
            def f(x, y, _m=mags[c]):
                i = np.trunc(np.asarray(x, np.float32) * sr32
                             / hop32).astype(np.int64)
                j = np.trunc(np.asarray(y, np.float32)
                             / binw32).astype(np.int64)
                # reference indexes UNCHECKED (PVGraph.cpp:26); clamp
                m = _m[np.clip(i, 0, F - 1), np.clip(j, 0, B - 1)]
                s = np.sqrt(m / np.float32(max_mag)).astype(np.float32)
                two_plus = (np.float32(2.0)
                            + np.asarray(y, np.float32))   # f32 add,
                return (s.astype(np.float64)               # f64 log2
                        * np.log2(two_plus.astype(np.float64))
                        / 4.0).astype(np.float32)
            return f

        g.draw_spectrograms(
            [make_f(c) for c in range(self.num_channels)],
            Rect(0, 0, self.length, self.bin_to_frequency(self.num_bins)))
    if timeline_scale > 0:
        big = _big_time_jump(domain.w)
        g.draw_x_ticks(big / 4.0, domain.y2, 1.0,
                       int(timeline_scale / 2), 0, -1,
                       Color.from_hsv(0, 0, 0.6), 0.0)
        g.draw_x_ticks(big, domain.y2, 1.0, int(timeline_scale), 0, -1,
                       Color.from_hsv(0, 0, 1.0), timeline_scale)
    return g


def pv_save_to_bmp(self, filename: str, domain=None, width: int = -1,
                   height: int = -1) -> None:
    pv_convert_to_graph(self, domain, width, height).save_image(filename)
