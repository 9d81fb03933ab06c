"""Wavetable: pitch-tracked waveform extraction and playback synthesis.

JAX implementation of the reference Wavetable
(reference: src/flan/Wavetable.h:12-126, Wavetable.cpp), golden-tested
against the compiled reference (tests/test_algo_golden.py wt_* fixtures).
Structure:

* The constructor's segmentation walk and zero-crossing snapping are
  host-side integer control flow (tiny data) fed by the batched YIN op;
  the per-waveform spectral resample (Wavetable.cpp:67-132: rFFT ->
  zero-pad -> irFFT -> zero-crossing realign -> 1/N scale) runs at
  constructor time on host numpy — it is one-time planning, like the
  streamed pipelines' host-computed remap plans. The finished table is
  a device array.
* Playback (Wavetable.cpp:266-334) follows the repitch recipe
  (audio/temporal.py): the reference's blockwise WDL-sinc feed loop is
  simulated exactly on host to produce read positions over the
  crossfaded table stream, then the output is ONE device program — a
  static table-stream gather + dense 64-tap windowed-sinc gather
  (flan_tpu.ops.resample.fractional_gather).

Reference quirks preserved (golden-tested): the table keeps one
all-zero slot per channel past the last resampled cycle
(resample_waveforms sizes by starts.size() but fills starts.size()-1,
Wavetable.cpp:77-88 — and ratio_to_table_index can land on it);
ratio_to_table_index TRUNCATES r*num_source_frames to an integer frame
before interpolating; the segmentation walk truncates the float
wavelength estimates at every use. One upstream BUG is documented in
docs/PARITY.md instead of replicated: the functional constructor
(Wavetable.cpp:235-248) writes every wave's samples to wave 0's slots,
leaving waves 1.. all-zero; we fill each wave (identical for
num_waves=1, which is what the golden pins).
"""
from __future__ import annotations

import functools
import math
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import as_function
from flan_tpu.ops.resample import fractional_gather


class SnapMode:
    NONE = "none"
    ZERO = "zero"
    LEVEL = "level"


class PitchMode:
    NONE = "none"
    LOCAL = "local"
    GLOBAL = "global"


def _snap_frame(data: np.ndarray, frame: int, height: float,
                search: int) -> int:
    """Nudge frame to the nearest crossing of `height`
    (reference snap_frame_to_sample, Wavetable.cpp:19-60)."""
    n = len(data)
    frame = int(np.clip(frame, 0, n - 1))
    search = int(max(search, 0))
    lo = max(frame - search, 0)
    hi = min(frame + search, n - 1)
    above = data[frame] > height
    for off in range(search + 1):
        left = frame - off
        if left >= lo and (data[left] > height) != above:
            return left + 1
        right = frame + off
        if right < hi and (data[right] > height) != above:
            return right
    # cross search failed: frame with output nearest the crossing, with
    # a distance-weighted norm; the reference's sequential strict-< scan
    # keeps frame_to_snap on ties and otherwise lands on the FIRST
    # occurrence of the window minimum (Wavetable.cpp:40-59)
    window = np.arange(lo, hi + 1)
    r = 1.0 + np.abs(window - frame).astype(np.float32) / np.float32(
        max(search, 1))
    dist = np.abs(data[window] - np.float32(height)) * r
    d_frame = dist[frame - lo]
    m = dist.min()
    if m < d_frame:
        return int(window[int(dist.argmin())])
    return frame


class Wavetable:
    """table: [channels, num_waves, wavelength] float32 device array."""

    def __init__(self, source=None, snap_mode: str = SnapMode.ZERO,
                 pitch_mode: str = PitchMode.LOCAL, wavelength: int = 2048,
                 snap_ratio: float = 0.3, fixed_frame_size: int = 256,
                 *, _table=None, _starts=None, _num_source_frames=0,
                 _sample_rate=48000.0):
        if source is None:
            self.table = _table
            self.waveform_starts = _starts or []
            self.wavelength = wavelength
            self.num_source_frames = _num_source_frames
            self.sample_rate = _sample_rate
            return
        self.wavelength = wavelength
        self.sample_rate = float(source.sample_rate)
        self.num_source_frames = source.num_frames
        self.waveform_starts = _get_waveform_starts(
            source, snap_mode, pitch_mode, wavelength, snap_ratio,
            fixed_frame_size)
        self.table = _resample_waveforms(source, self.waveform_starts,
                                         wavelength)

    @staticmethod
    def from_function(f, num_waves: int, wavelength: int = 2048,
                      sample_rate: float = 48000.0) -> "Wavetable":
        """Sample f on [k, k+1) per wave (reference Wavetable.cpp:235-248;
        table sample rate fixed at 48000 upstream). The upstream
        table-fill indexing bug for num_waves > 1 is NOT replicated
        (docs/PARITY.md): each wave gets its own samples here."""
        fn = as_function(f)
        grid = (jnp.arange(num_waves)[:, None]
                + jnp.arange(wavelength)[None, :] / wavelength)
        table = jnp.asarray(fn(grid.astype(jnp.float32)),
                            jnp.float32)[None]  # [1, W, L]
        wt = Wavetable(_table=table,
                       _starts=[list(range(num_waves))],
                       _num_source_frames=num_waves,
                       _sample_rate=sample_rate, wavelength=wavelength)
        return wt

    def is_null(self) -> bool:
        return (self.table is None or self.wavelength <= 0
                or not self.waveform_starts
                or any(len(s) == 0 for s in self.waveform_starts)
                or self.num_source_frames <= 0)

    def get_num_waveforms(self, channel: int = 0) -> int:
        return len(self.waveform_starts[channel])

    def get_waveform(self, waveform_index: int, channel: int) -> np.ndarray:
        """One table cycle as a numpy array (reference Wavetable.cpp:454-461
        returns a raw sample pointer; an array is the Python analog)."""
        return np.asarray(self.table[channel, waveform_index])

    def ratio_to_table_index(self, r, channel: int = 0):
        """Map a [0,1] source-position ratio to a fractional table index,
        preserving the source-time distribution of extracted waveforms
        (reference Wavetable.cpp:463-488). The source frame is the
        TRUNCATED integer r * num_source_frames, matching the reference's
        Frame cast."""
        out = self._ratio_to_table_index(np.asarray(r), channel)
        return float(out) if np.ndim(r) == 0 else out

    def _ratio_to_table_index(self, r: np.ndarray, channel: int
                              ) -> np.ndarray:
        starts = np.asarray(self.waveform_starts[channel], np.int64)
        size = len(starts)
        nsf = np.float32(self.num_source_frames)
        # Frame source_frame = r * num_source_frames (f32 mult, int trunc)
        src = np.trunc(np.asarray(r, np.float32) * nsf).astype(np.int64)
        ri = np.searchsorted(starts, src, side="right")
        ric = np.clip(ri, 1, size - 1)
        left = starts[ric - 1]
        right = starts[ric]
        idx = (ric - 1).astype(np.float32) + (
            (src - left).astype(np.float32)
            / np.maximum(right - left, 1).astype(np.float32))
        idx = np.clip(idx, 0.0, np.float32(size - 1))
        idx = np.where(ri == 0, 0.0, idx)
        idx = np.where(ri == size, np.float32(size - 1), idx)
        idx = np.where(src <= 0, 0.0, idx)
        idx = np.where(src.astype(np.float32) > nsf,
                       np.float32(size - 1), idx)
        return idx

    # --- Playback (reference Wavetable.cpp:266-334) -------------------------
    def synthesize(self, length: float, freq, ratio=0.0,
                   smooth: bool = True, granularity: float = 0.001):
        """Variable-rate wavetable playback.

        The reference drives a WDL sinc-64 resampler in `granularity`
        blocks, feeding it the (crossfaded, for smooth=True) table read
        as a periodic stream (Wavetable.cpp:266-334). The feed loop is
        simulated exactly on host (same WDL arithmetic as
        audio/temporal.py repitch: prepare/feed/bookkeeping, history
        zero-pad, anti-alias cutoff 1/(1.03*ratio)); the device program
        is one table-stream gather + one dense 64-tap sinc gather."""
        from flan_tpu.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        sr = self.sample_rate
        L = self.wavelength
        num_out = int(np.float32(length) * np.float32(sr))
        gran = max(1, int(np.float32(granularity) * np.float32(sr)))
        if num_out < 1:
            return Audio.create_null()

        freq_fn = as_function(freq)
        ratio_fn = as_function(ratio)
        # every block time is some out_gen/sr: evaluate both Functions on
        # the full frame grid once (f32, like the reference's lambdas)
        tgrid = (np.arange(num_out, dtype=np.float32)
                 / np.float32(sr)).astype(np.float32)

        def grid_eval(fn):
            if fn.is_constant:
                return np.full(num_out, np.float32(fn.constant_value),
                               np.float32)
            return np.asarray(fn(jnp.asarray(tgrid, jnp.float32)),
                              np.float32).reshape(-1)

        f_grid = grid_eval(freq_fn)
        r_grid = grid_eval(ratio_fn)
        in_freq = float(sr) / L                       # double, as upstream

        rows = []
        for channel in range(self.table.shape[0]):
            plan = _wavetable_wdl_plan(
                num_out, gran, f_grid, in_freq,
                self._ratio_to_table_index(r_grid, channel),
                self.get_num_waveforms(channel))
            pos, rate, sreqs, lefts, rights, rems = plan

            P = int(sreqs.sum())
            if P == 0:
                rows.append(jnp.zeros(num_out, jnp.float32))
                continue
            cutoff = np.where(rate > 1.0, 1.0 / (1.03 * rate), 1.0)
            # ONE jitted device program per channel; only the small
            # per-block plan rows and the per-output pos/cutoff (the
            # repitch precedent) go to the device — the P-length stream
            # expansion happens on device
            out = _synthesize_stream_core(
                self.table[channel],
                jnp.asarray(sreqs, jnp.int32),
                jnp.asarray(lefts, jnp.int32),
                jnp.asarray(rights, jnp.int32),
                jnp.asarray(rems, jnp.float32),
                jnp.asarray(pos, jnp.float32),
                jnp.asarray(cutoff, jnp.float32),
                total_fed=P, smooth=smooth)
            rows.append(out)
        return Audio(data=jnp.stack(rows).astype(jnp.float32),
                     sample_rate=sr)

    # --- Observability (reference Wavetable.cpp:336-357) --------------------
    def graph_waveform_range(self, channel: int, start: int, num: int):
        """Stacked waveform plots of table entries [start, start+num)."""
        from flan_tpu.graph.graph import Graph, WaveformMode
        from flan_tpu.utils.geometry import Color, Rect
        g = Graph(-1, -1)
        if self.is_null():
            return g
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.add_full_split_view_y(Rect(0, -1, 1, 1), num)
        rows = [np.asarray(self.table[channel, i])
                for i in range(start, start + num)
                if 0 <= i < self.get_num_waveforms(channel)]
        g.draw_waveforms(rows, Rect(0, -1, 1, 1), 0, WaveformMode.DIRECT)
        return g

    def save_waveform_range_to_bmp(self, filename: str, channel: int,
                                   start: int, num: int) -> None:
        self.graph_waveform_range(channel, start, num).save_image(filename)

    # --- Edit ops (reference Wavetable.cpp:364-451) -------------------------
    def add_fades_in_place(self, fade_frames: int = 32) -> None:
        env = _edge_fade_env(self.wavelength, fade_frames)
        self.table = self.table * env[None, None, :]

    def remove_jumps_in_place(self, fade_frames: int = 32) -> None:
        mid = (self.table[..., :1] + self.table[..., -1:]) / 2.0
        env = _edge_fade_env(self.wavelength, fade_frames)
        self.table = (self.table - mid) * env[None, None, :] + mid

    def remove_dc_in_place(self) -> None:
        self.table = self.table - jnp.mean(self.table, axis=-1,
                                           keepdims=True)

    def normalize_in_place(self) -> None:
        peak = jnp.max(jnp.abs(self.table), axis=-1, keepdims=True)
        self.table = jnp.where(peak < 1e-3, self.table,
                               self.table / jnp.maximum(peak, 1e-9))


@functools.partial(jax.jit, static_argnames=("total_fed", "smooth"))
def _synthesize_stream_core(table, sreqs, lefts, rights, rems, pos,
                            cutoff, *, total_fed: int, smooth: bool):
    """Device half of synthesize: expand the per-block feed plan into
    the periodic (crossfaded) table stream ON DEVICE, then one dense
    64-tap sinc gather. Inputs sent to the device are the [nblocks]
    plan rows and the [num_out] positions/cutoffs only."""
    L = table.shape[1]
    nblocks = sreqs.shape[0]
    # block id of each fed stream position (repeat with a static total)
    blk = jnp.repeat(jnp.arange(nblocks, dtype=jnp.int32), sreqs,
                     total_repeat_length=total_fed)
    tbl_col = jnp.mod(jnp.arange(total_fed, dtype=jnp.int32), L)
    left_v = table[lefts[blk], tbl_col]
    if smooth:
        right_v = table[rights[blk], tbl_col]
        rem_v = rems[blk]
        stream = left_v * (1.0 - rem_v) + right_v * rem_v
    else:
        stream = left_v
    return fractional_gather(stream[None, :], pos, cutoff,
                             num_taps=64)[0]


def _wavetable_wdl_plan(num_out: int, gran: int, f_grid: np.ndarray,
                        in_freq: float, tix_grid: np.ndarray,
                        num_waves: int):
    """Host simulation of synthesize's WDL feed loop
    (Wavetable.cpp:288-332 driving WDL resample.cpp sinc-64 mode;
    the same per-block arithmetic as audio/temporal._wdl_sinc_plan,
    with three wavetable-specific behaviors: the rate AND table index
    are selected by the OUTPUT head (out_frames_generated), the input
    is the endless periodic table stream (never terminates), and the
    output head advances by ResampleOut's return value).

    Returns (positions [num_out] float64 in fed-stream coordinates,
    rates [num_out], sreq per block, left/right table indices and
    crossfade remainder per block)."""
    SINC, HFS = 64, 32
    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    sreqs: List[int] = []
    lefts: List[int] = []
    rights: List[int] = []
    rems: List[float] = []

    samples_in = 0
    fracpos = 0.0
    win = 0                     # fed-stream position of rsinbuf[0]
    out_gen = 0
    while out_gen < num_out:
        ratio = float(f_grid[out_gen]) / in_freq      # double m_ratio
        tix = np.float32(tix_grid[out_gen])
        left = int(math.floor(tix))
        right = min(int(math.ceil(tix)), num_waves - 1)
        rem = float(np.float32(tix - np.float32(left)))
        # ResamplePrepare (resample.cpp:1218-1264): zero history pad
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        sreq = int(ratio * gran) + 4 + SINC - samples_in
        if sreq < 0:
            sreq = 0
        sreqs.append(sreq)
        lefts.append(left)
        rights.append(right)
        rems.append(rem)
        samples_in += sreq
        # ResampleOut (resample.cpp:1313-1415): produce until the filter
        # runs out of input or the output is full
        filtlen = samples_in - SINC
        srcpos = fracpos
        ret = 0
        while out_gen + ret < num_out:
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            pos[out_gen + ret] = win + srcpos + (HFS - 1)
            rate[out_gen + ret] = ratio
            srcpos += ratio
            ret += 1
        out_gen += ret
        if ret == 0 and sreq == 0:
            break               # rate too small to ever advance
        # post-loop bookkeeping (resample.cpp:1556-1570)
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return (pos, rate, np.asarray(sreqs, np.int64),
            np.asarray(lefts, np.int64), np.asarray(rights, np.int64),
            np.asarray(rems, np.float64))


def _edge_fade_env(wavelength: int, fade_frames: int) -> jnp.ndarray:
    """sin fade at both waveform edges (reference Wavetable.cpp:375-380)."""
    env = np.ones(wavelength, np.float32)
    for f in range(max(fade_frames - 1, 0)):
        fade = math.sin(math.pi / 2.0 * (f + 1) / fade_frames)
        env[f] *= fade
        env[wavelength - 1 - f] *= fade
    return jnp.asarray(env)


def _get_waveform_starts(source, snap_mode, pitch_mode, wavelength,
                         snap_ratio, fixed_frame) -> List[List[int]]:
    """Sequential pitch-following waveform segmentation
    (reference get_waveform_starts, Wavetable.cpp:134-218). All float
    wavelength estimates TRUNCATE to integer frames at use, matching the
    reference's Frame casts (golden-tested via wt_meta)."""
    if source.is_null() or fixed_frame < 1 or not (0 < snap_ratio < 0.95):
        return []
    lp = source.filter_1pole_lowpass(4000.0, 2)
    ac_gran = 128

    out = []
    for channel in range(source.num_channels):
        data = np.asarray(source.data[channel])
        local = np.zeros(0)
        global_wl = 0
        mode = pitch_mode
        if mode != PitchMode.NONE:
            local = np.asarray(lp.get_local_wavelengths(
                channel, 0, -1, wavelength, ac_gran, 1.0, 32))
            # Frame global_wavelength = get_average_wavelength(...):
            # the float estimate truncates at assignment
            global_wl = int(lp.get_average_wavelength(local, 0.2, 64.0))
            if mode == PitchMode.GLOBAL and global_wl == -1:
                mode = PitchMode.NONE

        def snap(frame, src_frame, max_snap):
            if snap_mode == SnapMode.NONE:
                return int(frame)
            height = 0.0 if snap_mode == SnapMode.ZERO else float(
                data[int(np.clip(src_frame, 0, len(data) - 1))])
            return _snap_frame(data, int(frame), height, int(max_snap))

        starts = [snap(0, 0, snap_ratio * max(global_wl, 0))]
        while True:
            if mode == PitchMode.LOCAL:
                li = int(starts[-1] // ac_gran)
                if li >= len(local):
                    break
                wl = int(local[li])     # Frame local_wavelength_c
                if wl > 0:
                    expected = wl
                elif global_wl > 0:
                    expected = global_wl
                else:
                    expected = fixed_frame
            elif mode == PitchMode.GLOBAL:
                expected = global_wl
            else:
                expected = fixed_frame
            expected = int(expected)
            if expected < 1 or starts[-1] + expected >= source.num_frames:
                break
            starts.append(snap(starts[-1] + expected, starts[-1],
                               snap_ratio * expected))
        out.append(starts)
    return out


def _resample_waveforms(source, waveform_starts, wavelength):
    """Per-cycle spectral resample to the fixed wavelength (reference
    resample_waveforms, Wavetable.cpp:67-132): rFFT of the cycle,
    zero-padded spectrum, inverse FFT at the table wavelength, realign
    to the first zero crossing within 10% of the wavelength, scale by
    1/num_input_frames. Host numpy (one-time constructor planning); the
    table ships to device for playback.

    Quirks preserved: one trailing all-zero slot per channel (the
    reference sizes the table by starts.size() and fills size-1); the
    zero-crossing search alternates end/start like the reference; a
    cycle LONGER than the wavelength would overrun the reference's ifft
    buffer (heap UB, Wavetable.cpp:100) — here the spectrum truncates."""
    if source.is_null() or not waveform_starts:
        return None
    L = wavelength
    nb_out = L // 2 + 1
    sd = int(np.float32(L) * np.float32(0.1))        # Frame search dist
    channels = []
    for channel, starts in enumerate(waveform_starts):
        W = max(len(starts), 1)
        tab = np.zeros((W, L), np.float32)
        data = np.asarray(source.data[channel], np.float64)
        for w in range(len(starts) - 1):
            a, b = starts[w], starts[w + 1]
            num_in = b - a
            if num_in <= 0:
                continue
            sp = np.fft.rfft(data[a:b])
            spec = np.zeros(nb_out, np.complex128)
            k = min(len(sp), nb_out)
            spec[:k] = sp[:k]
            y = (np.fft.irfft(spec, L) * L / num_in).astype(np.float32)
            above = y[0] > 0
            zc = 0
            for off in range(1, sd + 1):
                if (y[L - off] > 0) != above:
                    zc = L - off
                    break
                if (y[off] > 0) != above:
                    zc = off
                    break
            tab[w] = np.roll(y, -zc)
        channels.append(tab)
    max_w = max(ch.shape[0] for ch in channels)
    padded = [np.pad(ch, [(0, max_w - ch.shape[0]), (0, 0)])
              for ch in channels]
    return jnp.asarray(np.stack(padded))
