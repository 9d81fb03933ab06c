"""PV selection / combination / generation / extras.

JAX re-design of the reference PV algorithms
(reference: src/flan/PV/PV.cpp). Scatter-with-max loops become jnp
scatter-max or max-affine scans; per-frame magnitude sorts become batched
argsorts. Bound onto PV in flan_tpu.pv.__init__.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func import interpolators
from flan_tpu.func.function import as_function, as_function2d
from flan_tpu.ops.scan import max_affine_recurrence
from flan_tpu.ops.windows import hann


def get_bin_interpolated(self, channel: int, frame: float, b: float,
                         interp: Callable = interpolators.linear):
    """Bilinear MF read (reference PV.cpp:41-60)."""
    f0 = int(np.floor(frame))
    f1 = int(np.ceil(frame))
    b0 = int(np.floor(b))
    b1 = int(np.ceil(b))
    l = float(interp(jnp.float32(frame - f0)))
    m = float(interp(jnp.float32(b - b0)))
    mg = self.mag[channel]
    fq = self.freq[channel]
    mix = lambda a: ((1 - m) * ((1 - l) * a[f0, b0] + l * a[f1, b0])
                     + m * ((1 - l) * a[f0, b1] + l * a[f1, b1]))
    return float(mix(mg)), float(mix(fq))


def select(self, length: float, selector,
           interp: Callable = interpolators.linear):
    """Inverse-map gather with frequency rescale
    (reference PV.cpp:92-127)."""
    from flan_tpu.pv.pv import PV
    if self.is_null() or length <= 0:
        return PV.create_null()
    out_frames = int(self.time_to_frame(length))
    fn = as_function2d(selector)

    t = jnp.arange(out_frames, dtype=jnp.float32) / self.analysis_rate
    fr = jnp.arange(self.num_bins, dtype=jnp.float32) * self.bin_width
    sel = fn(t[:, None], fr[None, :])
    # selector returns (time, frequency) pairs; accept stacked last axis or
    # a tuple of two arrays
    if isinstance(sel, tuple):
        sel_t, sel_f = sel
    else:
        sel = jnp.asarray(sel)
        sel_t, sel_f = sel[..., 0], sel[..., 1]
    sel_t = jnp.broadcast_to(sel_t, (out_frames, self.num_bins))
    sel_f = jnp.broadcast_to(sel_f, (out_frames, self.num_bins))

    src_frame = (sel_t * self.analysis_rate).astype(jnp.int32)
    src_bin = (sel_f / self.bin_width).astype(jnp.int32)
    valid = ((src_frame >= 0) & (src_frame < self.num_frames - 1)
             & (src_bin >= 0) & (src_bin < self.num_bins - 1))
    sf = jnp.clip(src_frame, 0, self.num_frames - 1)
    sb = jnp.clip(src_bin, 0, self.num_bins - 1)
    mag = self.mag[:, sf, sb]
    freq = self.freq[:, sf, sb]
    # frequency rescale (PV.cpp:120-121)
    scale = jnp.where(sel_f > 1.0,
                      (jnp.arange(self.num_bins, dtype=jnp.float32)
                       * self.bin_width)[None, :] / jnp.maximum(sel_f, 1e-9),
                      1.0)
    freq = freq * scale[None]
    v = valid[None]
    return self._with(mag=jnp.where(v, mag, 0.0),
                      freq=jnp.where(v, freq, 0.0))


def freeze(self, pause_times: Sequence[float],
           pause_lengths: Sequence[float]):
    """Frame-repetition schedule -> one gather (reference PV.cpp:129-198)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    if len(pause_times) != len(pause_lengths):
        return PV.create_null()
    timing = sorted(
        {int(np.clip(self.time_to_frame(t), 0, self.num_frames - 1)):
         max(int(self.time_to_frame(l)), 0)
         for t, l in zip(pause_times, pause_lengths)}.items())
    # Reference quirk (PV.cpp:175-194, golden-tested): a frozen frame is
    # written `length` times INSTEAD of once (the else branch is skipped),
    # so a zero-length pause drops its frame entirely, and the output
    # buffer — sized num_frames + sum(lengths) — keeps one trailing ZERO
    # frame per pause. (For duplicate pause frames the reference's
    # unstable sort + unique keeps an unspecified entry; we keep the last.)
    index_map = []
    ti = 0
    for in_frame in range(self.num_frames):
        if ti < len(timing) and in_frame == timing[ti][0]:
            index_map.extend([in_frame] * timing[ti][1])
            ti += 1
        else:
            index_map.append(in_frame)
    n_out = self.num_frames + sum(l for _, l in timing)
    idx = jnp.asarray(index_map, jnp.int32)
    mag = self.mag[:, idx]
    freq = self.freq[:, idx]
    pad = n_out - len(index_map)
    if pad > 0:
        mag = jnp.pad(mag, [(0, 0), (0, pad), (0, 0)])
        freq = jnp.pad(freq, [(0, 0), (0, pad), (0, 0)])
    return self._with(mag=mag, freq=freq)


def replace_amplitudes(self, amp_source, amount=1.0):
    """(reference PV.cpp:205-236)"""
    from flan_tpu.pv.pv import PV
    if self.is_null() or amp_source.is_null():
        return PV.create_null()
    c = min(self.num_channels, amp_source.num_channels)
    f = min(self.num_frames, amp_source.num_frames)
    b = min(self.num_bins, amp_source.num_bins)
    amt = jnp.clip(self._sample_2d(amount), 0.0, 1.0)
    amt = jnp.broadcast_to(amt, (self.num_frames, self.num_bins))[:f, :b]
    mag = jnp.zeros_like(self.mag)
    mag = mag.at[:c, :f, :b].set(
        amp_source.mag[:c, :f, :b] * amt[None]
        + self.mag[:c, :f, :b] * (1.0 - amt)[None])
    freq = jnp.zeros_like(self.freq)
    freq = freq.at[:c, :f, :b].set(self.freq[:c, :f, :b])
    return self._with(mag=mag, freq=freq)


def subtract_amplitudes(self, amp_source, amount=1.0):
    """(reference PV.cpp:238-264)"""
    from flan_tpu.pv.pv import PV
    if self.is_null() or amp_source.is_null():
        return PV.create_null()
    c = min(self.num_channels, amp_source.num_channels)
    f = min(self.num_frames, amp_source.num_frames)
    b = min(self.num_bins, amp_source.num_bins)
    amt = jnp.broadcast_to(self._sample_2d(amount),
                           (self.num_frames, self.num_bins))[:f, :b]
    mag = self.mag.at[:c, :f, :b].set(
        jnp.abs(self.mag[:c, :f, :b]
                - amp_source.mag[:c, :f, :b] * amt[None]))
    return self._with(mag=mag, freq=self.freq)


def synthesize(length: float, freq, harmonic_weights=None,
               harmonic_bandwidth=60.0, harmonic_frequency_std_dev=0.0,
               *, seed: int = 0):
    """Generate a PV from harmonic descriptions (reference
    PV.cpp:271-356): each harmonic spreads a hann profile over
    `bandwidth` Hz. Computed as one dense (frame, bin) evaluation - each
    bin finds the harmonic whose profile covers it (highest harmonic wins,
    matching the reference's overwrite order)."""
    from flan_tpu.pv.pv import PV
    from flan_tpu.core.pv_buffer import PVFormat
    fmt_bins, sr, hop, window = 2049, 48000.0, 128, 2048
    out = PV.create_from_format(
        PVFormat(1, int(length * sr / hop), fmt_bins, sr, hop, window))
    if out.num_frames <= 0:
        return PV.create_null()
    F, B = out.num_frames, out.num_bins
    height = out.bin_to_frequency(B - 1)
    scale = math.sqrt(out.dft_size)
    min_frequency = height / B / 2.0

    freq_fn = as_function(freq)
    t = jnp.arange(F, dtype=jnp.float32) / out.analysis_rate
    base = jnp.maximum(jnp.broadcast_to(
        jnp.asarray(freq_fn(t), jnp.float32), (F,)), min_frequency)

    bw_fn = as_function(harmonic_bandwidth)
    bw = jnp.broadcast_to(jnp.asarray(bw_fn(t), jnp.float32), (F,)) / 2.0

    weights_fn = harmonic_weights if harmonic_weights is not None else (
        lambda tt, h: 1.0 / h)
    sd_fn = as_function2d(harmonic_frequency_std_dev)

    bin_f = jnp.arange(B, dtype=jnp.float32) * out.bin_width  # [B]
    # candidate harmonic covering each (frame, bin): the highest h with
    # h*base - bw <= bin_f (the reference writes harmonics in ascending
    # order so later/higher overwrites)
    h = jnp.floor((bin_f[None, :] + bw[:, None]) / base[:, None])
    max_h = jnp.floor(height / base)  # harmonics per frame (PV.cpp:297-299)
    h = jnp.clip(h, 0, max_h[:, None])
    central = h * base[:, None]
    low = central - bw[:, None]
    high = central + bw[:, None]
    covered = (h >= 1) & (bin_f[None, :] >= low) & (bin_f[None, :] <= high)

    w = jnp.asarray(weights_fn(t[:, None], jnp.maximum(h, 1.0)),
                    jnp.float32)
    w = jnp.broadcast_to(w, (F, B))
    pos = (bin_f[None, :] - low) / jnp.maximum(high - low, 1e-9)
    mag = jnp.where(covered, w * scale * hann(pos), 0.0)

    sd = jnp.broadcast_to(jnp.asarray(
        sd_fn(t[:, None], bin_f[None, :]), jnp.float32), (F, B))
    key = jax.random.PRNGKey(seed)
    noise = jax.random.normal(key, (F, B), jnp.float32)
    freq_out = jnp.where(covered,
                         central + jnp.where(sd > 0, noise * sd, 0.0), 0.0)
    return out._with(mag=mag[None], freq=freq_out[None])


def _harmonic_scaler(self, series, harmonic_freq_fn, num_harmonics: int):
    """Scatter-max harmonic painting (reference harmonic_scaler,
    PV.cpp:362-407). The series is sampled on the host per harmonic (the
    reference's Function<pair<Second, Harmonic>, Magnitude> is scalar over
    time, so this costs [H, F] floats), then both write passes run as
    lax.scans over harmonics - a data-derived harmonic count cannot
    explode the trace."""
    c, f, b = self.mag.shape
    t = jnp.arange(f, dtype=jnp.float32) / self.analysis_rate
    frame_ix = jnp.arange(f)[None, :, None]
    chan_ix = jnp.arange(c)[:, None, None]

    series_fn = series if callable(series) else (lambda tt, hh: series)

    def _series_row(h):
        raw = jnp.asarray(series_fn(t[:, None], h), jnp.float32)
        if raw.ndim == 2 and raw.shape[-1] != 1:
            raise ValueError(
                "harmonic series functions are scalar over (time, harmonic)"
                " - the reference's Function<pair<Second, Harmonic>,"
                " Magnitude> (PV.cpp:362-407); per-bin series are not"
                f" supported (got shape {raw.shape})")
        return jnp.broadcast_to(raw, (f, 1))[:, 0]

    s_grid = jnp.stack([_series_row(h)
                        for h in range(num_harmonics)])  # [H, F]
    hs = jnp.arange(num_harmonics, dtype=jnp.float32)

    def step_vals(h, s_row):
        hf = harmonic_freq_fn(self.freq, h + 1.0)     # [C, F, B]
        hbin = (hf / self.bin_width).astype(jnp.int32)
        val = self.mag * s_row[None, :, None]
        valid = (self.freq > 1.0) & (hbin < b) & (hbin >= 0)
        tb = jnp.clip(hbin, 0, b - 1)
        return tb, jnp.where(valid, val, -1.0), hf, valid

    def mag_body(out_m, inp):
        h, s_row = inp
        tb, val, _, _ = step_vals(h, s_row)
        return out_m.at[chan_ix, frame_ix, tb].max(val), None

    out_mag, _ = jax.lax.scan(mag_body, jnp.zeros_like(self.mag),
                              (hs, s_grid))

    def freq_body(out_f, inp):
        h, s_row = inp
        tb, val, hf, valid = step_vals(h, s_row)
        winner = out_mag[chan_ix, frame_ix, tb]
        write = valid & (val >= winner) & (val > 0)
        return out_f.at[chan_ix, frame_ix, tb].max(
            jnp.where(write, hf, -jnp.inf)), None

    out_freq, _ = jax.lax.scan(freq_body, jnp.full_like(self.freq, -jnp.inf),
                               (hs, s_grid))
    out_freq = jnp.where(jnp.isneginf(out_freq), 0.0, out_freq)
    return self._with(mag=jnp.maximum(out_mag, 0.0), freq=out_freq)


def add_octaves(self, series):
    """(reference PV.cpp:409-413)"""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    # reference: ceil(log2(get_height())) with height = bin_to_frequency(
    # num_bins) - the full band edge, not the last bin center (PV.cpp:413)
    height = self.bin_to_frequency(self.num_bins)
    n = int(math.ceil(math.log2(max(height, 2.0))))
    return _harmonic_scaler(self, series,
                            lambda fr, h: fr * (2.0 ** h), n)


def add_harmonics(self, series, max_harmonics: Optional[int] = None):
    """(reference PV.cpp:415-419). The reference paints exactly num_bins
    harmonics per partial (harmonic_scaler is called with
    num_harmonics = get_num_bins(); the per-MF loop also breaks at the
    band edge, so sub-bin-width partials get *fewer* in-band harmonics
    than would fit - golden-tested vs the compiled reference in
    tests/test_algo_golden.py). max_harmonics optionally lowers the pass
    count (each harmonic is a full-plane scatter pass here)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    n = self.num_bins
    if max_harmonics is not None:
        n = min(n, int(max_harmonics))
    return _harmonic_scaler(self, series,
                            lambda fr, h: fr * (h + 1.0), n)


def shape(self, shaper, use_shift_alignment: bool = False):
    """MF -> MF map (reference PV.cpp:421-458). shaper takes (mag, freq)
    arrays and returns (mag, freq)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    s_mag, s_freq = shaper(self.mag, self.freq)
    s_mag = jnp.broadcast_to(jnp.asarray(s_mag, jnp.float32),
                             self.mag.shape)
    s_freq = jnp.broadcast_to(jnp.asarray(s_freq, jnp.float32),
                              self.freq.shape)
    if not use_shift_alignment:
        return self._with(mag=s_mag, freq=s_freq)

    c, f, b = self.mag.shape
    bin_ix = jnp.arange(b)[None, None, :]
    # C truncation-toward-zero lands on the FLOAT expressions, nested
    # (PV.cpp:440-441): binShift = Bin(bin - f2b(in.f)), then
    # target = Bin(f2b(shaped.f) + binShift) — truncating f2b first
    # diverges on every fractional/negative frequency (golden-tested)
    bin_shift = jnp.trunc(bin_ix.astype(jnp.float32)
                          - self.freq / self.bin_width)
    target = jnp.trunc(s_freq / self.bin_width
                       + bin_shift).astype(jnp.int32)
    valid = (target >= 0) & (target < b)
    tb = jnp.clip(target, 0, b - 1)
    chan_ix = jnp.arange(c)[:, None, None]
    frame_ix = jnp.arange(f)[None, :, None]
    # out starts cleared {0, 0} and a bin writes only on strict magnitude
    # improvement (PV.cpp:446-448), so the zero init correctly blocks
    # non-positive shaped mags from ever writing
    out_mag = jnp.zeros_like(s_mag).at[chan_ix, frame_ix, tb].max(
        jnp.where(valid, s_mag, -1.0))
    winner = out_mag[chan_ix, frame_ix, tb]
    # the sequential strict-> write (PV.cpp:446-448) means the FIRST
    # source bin to reach the final max keeps its frequency: among
    # equal-magnitude ties the LOWEST source bin wins (a freq
    # scatter-max would wrongly pick the largest tied frequency)
    tie = valid & (s_mag == winner) & (s_mag > 0)
    src_bin = jnp.broadcast_to(bin_ix, s_mag.shape).astype(jnp.int32)
    win_src = jnp.full(s_mag.shape, b, jnp.int32).at[
        chan_ix, frame_ix, tb].min(jnp.where(tie, src_bin, b))
    got = jnp.take_along_axis(s_freq, jnp.clip(win_src, 0, b - 1),
                              axis=-1)
    out_freq = jnp.where(win_src < b, got, 0.0)
    return self._with(mag=jnp.maximum(out_mag, 0.0), freq=out_freq)


def _n_loudest_mask(self, num_partials, keep_loudest: bool):
    """Rank bins by |magnitude| per frame (reference
    predicateNLoudestPartials, PV.cpp:552-588)."""
    fn = as_function(num_partials)
    t = jnp.arange(self.num_frames, dtype=jnp.float32) / self.analysis_rate
    n = jnp.broadcast_to(jnp.asarray(fn(t), jnp.float32),
                         (self.num_frames,)).astype(jnp.int32)
    order = jnp.argsort(-jnp.abs(self.mag), axis=-1)
    ranks = jnp.argsort(order, axis=-1)   # rank of each bin by loudness
    if keep_loudest:
        keep = ranks < n[None, :, None]
    else:
        keep = ranks >= n[None, :, None]
    return self._with(mag=jnp.where(keep, self.mag, 0.0), freq=self.freq)


def retain_n_loudest_partials(self, num_partials):
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    return _n_loudest_mask(self, num_partials, True)


def remove_n_loudest_partials(self, num_partials):
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    return _n_loudest_mask(self, num_partials, False)


def resonate(self, length: float, decay):
    """Per-bin exponential decay with max against input: a max-affine
    recurrence solved in parallel (reference PV.cpp:602-641 runs it as a
    sequential frame loop)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    length = max(length, 0.0)
    extra = int(math.ceil(self.time_to_frame(length)))
    f_out = self.num_frames + extra
    c, f_in, b = self.mag.shape

    fn = as_function2d(decay)
    t = jnp.arange(f_out, dtype=jnp.float32) / self.analysis_rate
    fr = jnp.arange(b, dtype=jnp.float32) * self.bin_width
    dec = jnp.clip(jnp.broadcast_to(
        jnp.asarray(fn(t[:, None], fr[None, :]), jnp.float32),
        (f_out, b)), 0.0, 1.0)
    spf = 1.0 / self.analysis_rate
    a = jnp.power(dec, spf)[None]                     # [1, F_out, B]

    m_in = jnp.zeros((c, f_out, b), jnp.float32).at[:, :f_in].set(self.mag)
    # y[f] = max(m_in[f], a[f] * y[f-1])
    y = max_affine_recurrence(m_in, jnp.broadcast_to(a, m_in.shape),
                              jnp.zeros_like(m_in), axis=1)
    won = m_in >= y - 1e-12
    # frequency follows the last winning input frame
    f_idx = jnp.arange(f_out)[None, :, None]
    last_win = jax.lax.associative_scan(
        jnp.maximum, jnp.where(won, f_idx, 0), axis=1)
    freq_in = jnp.zeros((c, f_out, b), jnp.float32).at[:, :f_in].set(
        self.freq)
    freq = jnp.take_along_axis(freq_in, last_win, axis=1)
    return self._with(mag=y, freq=freq)


def perturb(self, mf_std_dev, damping: float = 0.99, *, seed: int = 0):
    """Randomly perturb the MF data, activated from the reference's
    commented experimental implementation (PV.cpp:460-548): frequency
    accelerations ~ N(0, f_std(t, f)/20) accumulate through TWO damped
    recurrences — along frames per bin, then along bins per frame, each
    step scaled by `damping` — and land scaled by 200; magnitudes get a
    per-frame random-walk offset ~ N(0, m_std(t, bin 0)/20) shared by
    every bin of the frame (the reference samples the magnitude std at
    bin 0 — preserved), drawn independently per channel.

    Two deliberate deviations from the commented code, both documented
    upstream as unfinished ("Magnitude is currently unimplimented...",
    PV.cpp:465-470): the final frequency read uses the full
    per-(frame, bin) offset field the code computes (the comment-era
    indexing read only the frame-0 row), and the reference's
    std::time(nullptr) seeding becomes an explicit `seed` (the repo
    convention for every reference RNG, SURVEY §7).

    mf_std_dev: a (mag_std, freq_std) pair, each a constant or a
    Function of (time, frequency); negative stds clamp to 0.
    """
    from flan_tpu.func.function import as_function2d
    from flan_tpu.ops.scan import linear_recurrence
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    try:
        m_in, f_in = mf_std_dev
    except TypeError:
        m_in = f_in = mf_std_dev
    m_fn = as_function2d(m_in)
    f_fn = as_function2d(f_in)

    c, nf, nb = self.mag.shape
    t = (jnp.arange(nf, dtype=jnp.float32) / self.analysis_rate)[:, None]
    fr = (jnp.arange(nb, dtype=jnp.float32) * self.bin_width)[None, :]
    m_std = jnp.maximum(jnp.broadcast_to(
        jnp.asarray(m_fn(t, fr), jnp.float32), (nf, nb)), 0.0)
    f_std = jnp.maximum(jnp.broadcast_to(
        jnp.asarray(f_fn(t, fr), jnp.float32), (nf, nb)), 0.0)

    eps = 1e-5
    key = jax.random.PRNGKey(seed)
    k_acc, k_mag = jax.random.split(key)
    accel = jnp.where(
        f_std < eps, 0.0,
        jax.random.normal(k_acc, (nf, nb), jnp.float32) * (f_std / 20.0))
    d = jnp.float32(damping)
    # the reference seeds each recurrence with its own first element and
    # then runs the loop from index 0 reading the seed (PV.cpp:496-523),
    # doubling the first step: v[0] = 2 d a[0] (per bin) and o[0] =
    # 2 d v[0] (per frame) - reproduced via y0
    velocs = linear_recurrence(d, d * accel, y0=accel[0],
                               axis=0)                 # frames, per bin
    offs = linear_recurrence(d, d * velocs, y0=velocs[:, 0:1],
                             axis=1)                   # bins, per frame

    mag_std0 = m_std[:, 0]
    steps = jnp.where(
        mag_std0[None, :] < eps, 0.0,
        jax.random.normal(k_mag, (c, nf), jnp.float32)
        * (mag_std0[None, :] / 20.0))
    mag_off = jnp.cumsum(steps, axis=1)

    return self._with(mag=self.mag + mag_off[:, :, None],
                      freq=self.freq + offs[None] * 200.0)
