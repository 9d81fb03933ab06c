"""PV salience / contours / prism (Salamon & Gomez melody machinery).

JAX re-design of the reference melody extraction
(reference: src/flan/PV/PVInformation.cpp). The salience map runs on device
with per-frame top-K peak batching and one scatter-add; contour tracking is
greedy control flow over sparse peak lists (host, numpy); prism vectorizes
each contour's per-frame harmonic rewrites. Bound onto PV in
flan_tpu.pv.__init__.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.ops.windows import hann

_NOTES_CLOSE_LO = 2.0 ** (-1.0 / 24.0)
_NOTES_CLOSE_HI = 2.0 ** (1.0 / 24.0)


@dataclasses.dataclass
class Salience:
    """(reference PV.h:131-137)"""
    num_frames: int = 0
    num_bins: int = 0
    buffer: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.float32))

    def get(self, frame: int, b: int) -> float:
        return float(self.buffer[frame, b])


@dataclasses.dataclass
class Contour:
    """(reference PV.h:153-162): bins holds (pitch_bin, salience) pairs."""
    pitch_mean: float = 0.0
    pitch_std_dev: float = 0.0
    salience_mean: float = 0.0
    salience_std_dev: float = 0.0
    start_frame: int = 0
    bins: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))


def _hann_dft2(f):
    out = jnp.where(
        jnp.abs(f) < 1e-9, 1.0,
        jnp.where(jnp.abs(jnp.abs(f) - 1.0) < 1e-9, 0.5,
                  jnp.sin(jnp.pi * f)
                  / (jnp.pi * f * (1.0 - f * f) + 1e-30)))
    return out


def get_salience(self, channel: int, min_frequency: float = 55.0,
                 max_frequency: float = 1760.0, max_peaks=None
                 ) -> Salience:
    """Perceived-pitch salience map (reference PVInformation.cpp:28-109):
    per-frame magnitude peaks, hann-DFT amplitude correction, subharmonic
    accumulation with cosine spreading.

    The reference walks every peak; here peaks batch through a per-frame
    top-K. K defaults to the *measured* max peak count over all frames
    (one cheap device reduction, rounded up to a multiple of 16 to bucket
    recompiles), so the default is exactly lossless. Pass an int to cap
    explicitly (cheaper on dense noise, quantified lossy)."""
    if self.is_null():
        return Salience()
    bin_effect_dist = 10
    nh = 20
    alpha = 0.8
    gamma = 40.0
    e_test = 10.0 ** (gamma / 20.0)
    log2_min = math.log2(min_frequency)
    sal_bins = int(round(120.0 * (math.log2(max_frequency) - log2_min)))

    mag = self.mag[channel]                      # [F, B]
    freq = self.freq[channel]
    f_cnt, b_cnt = mag.shape

    # strict local maxima (reference uses find_peaks without
    # interpolation; its walker's plateau handling is irrelevant here -
    # exactly-equal adjacent float magnitudes in a real spectrum are
    # measure-zero, so the cheap 3-point device test suffices)
    mid = mag[:, 1:-1]
    is_peak = (mid > mag[:, :-2]) & (mid >= mag[:, 2:])
    peak_mask = jnp.pad(is_peak, [(0, 0), (1, 1)])
    a_max = jnp.max(mag, axis=-1, keepdims=True)
    peak_mask = peak_mask & (mag > a_max / e_test)

    if max_peaks is None:
        # measured max peaks/frame -> lossless K (multiple of 16, >= 16)
        counts = jnp.sum(peak_mask, axis=-1)
        max_peaks = int(-(-max(int(jnp.max(counts)), 1) // 16) * 16)
    max_peaks = min(max_peaks, b_cnt)
    vals, idxs = jax.lax.top_k(jnp.where(peak_mask, mag, -1.0), max_peaks)
    picked = vals > 0                             # [F, K]
    i_f = jnp.take_along_axis(freq, idxs, axis=-1)

    # instantaneous amplitude correction (PVInformation.cpp:82-87)
    bin_offset = i_f / self.bin_width - idxs
    kernel = _hann_dft2(bin_offset * self.window_size / self.dft_size)
    i_m = jnp.where(kernel >= 0.5, vals / jnp.maximum(kernel, 1e-9), 0.0)
    i_m = jnp.where(picked & (i_f > 0), i_m, 0.0)

    h = jnp.arange(1, nh + 1, dtype=jnp.float32)      # [Nh]
    alpha_pow = alpha ** jnp.arange(nh, dtype=jnp.float32)
    sub_f = i_f[..., None] / h[None, None, :]          # [F, K, Nh]
    b_c = jnp.round(120.0 * (jnp.log2(jnp.maximum(sub_f, 1e-9))
                             - log2_min)).astype(jnp.int32)
    offs = jnp.arange(-bin_effect_dist, bin_effect_dist + 1)
    g = 0.5 * (1.0 + jnp.cos(
        jnp.abs(offs) / bin_effect_dist * jnp.pi / 2.0))   # [21]

    # The +-10-bin cosine spread factors out of the scatter: accumulate
    # only the center-bin weights into a (bin-extended) per-frame
    # histogram, then convolve along bins with the 21-tap spread kernel.
    # The naive [F, K, Nh, 21] scatter materializes index tensors whose
    # tiny trailing dims tile-pad to ~17 GB at 60 s (OOM).
    width = sal_bins + 2 * bin_effect_dist
    contrib = alpha_pow[None, None, :] * i_m[..., None]    # [F, K, Nh]
    valid = (b_c >= 0) & (b_c < width - bin_effect_dist) \
        & (i_f[..., None] > 0)
    frame_ix = jnp.broadcast_to(jnp.arange(f_cnt)[:, None, None],
                                b_c.shape)
    flat = (frame_ix * width
            + jnp.clip(b_c, 0, width - 1) + bin_effect_dist)
    hist = jnp.zeros((f_cnt * width,), jnp.float32).at[
        flat.reshape(-1)].add(jnp.where(valid, contrib, 0.0).reshape(-1))
    hist = hist.reshape(f_cnt, 1, width)
    sal = jax.lax.conv_general_dilated(
        hist, g[None, None, :], window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)[:, 0, :]
    peak = jnp.max(sal)
    sal = sal / jnp.where(peak > 0, peak, 1.0)
    return Salience(num_frames=f_cnt, num_bins=sal_bins,
                    buffer=np.asarray(sal))


def _frame_peaks(row: np.ndarray):
    """Interpolated local maxima of one salience frame, loudest first."""
    from flan_tpu.ops.dsp_utility import find_peaks
    return find_peaks(row, -1, True, True)


def get_contours(self, channel: int, min_frequency: float = 55.0,
                 max_frequency: float = 1760.0, filter_short: int = 30,
                 filter_quiet: float = 20.0) -> List[Contour]:
    """Greedy S+/S- contour tracking (reference
    PVInformation.cpp:111-263)."""
    t_plus = 0.9
    t_sigma = 0.9
    pitch_bin_cents = 10.0
    max_delta_pitch = 80.0
    max_gap = int(self.time_to_frame(0.1))

    sal = get_salience(self, channel, min_frequency, max_frequency)
    if sal.buffer.size == 0:
        return []
    nf = sal.num_frames

    s_plus: List[list] = []
    s_minus: List[list] = []
    for f in range(nf):
        peaks = _frame_peaks(sal.buffer[f])
        thresh = t_plus * sal.buffer[f].max()
        plus = [p for p in peaks if p[1] >= thresh]
        minus = [p for p in peaks if p[1] < thresh]
        s_plus.append([list(p) for p in plus])
        s_minus.append([list(p) for p in minus])

    all_plus = [p for f in s_plus for p in f]
    if not all_plus:
        return []
    ys = np.asarray([p[1] for p in all_plus])
    mean, sigma = ys.mean(), ys.std()
    global_thresh = mean - t_sigma * sigma
    for f in range(nf):
        keep, drop = [], []
        for p in s_plus[f]:
            (keep if p[1] >= global_thresh else drop).append(p)
        s_plus[f] = keep
        s_minus[f].extend(drop)

    delta = max_delta_pitch / pitch_bin_cents

    contours: List[Contour] = []
    while True:
        best_frame, best_val = -1, 0.0
        for f in range(nf):
            if s_plus[f] and s_plus[f][0][1] > best_val:
                best_val = s_plus[f][0][1]
                best_frame = f
        if best_frame < 0:
            break
        bins = [s_plus[best_frame].pop(0)]

        def extend(start, end, bins):
            step = 1 if end > start else -1
            current = bins[-1][0]
            gap = 0
            f = start
            while f != end and gap < max_gap:
                hit = next((p for p in s_plus[f]
                            if abs(p[0] - current) < delta), None)
                if hit is not None:
                    bins.append(hit)
                    current = hit[0]
                    s_plus[f].remove(hit)
                    gap = 0
                else:
                    hit = next((p for p in s_minus[f]
                                if abs(p[0] - current) < delta), None)
                    if hit is None:
                        break
                    bins.append(hit)
                    current = hit[0]
                    s_minus[f].remove(hit)
                    gap += 1
                f += step

        extend(best_frame - 1, -1, bins)
        start_frame = best_frame + 1 - len(bins)
        bins.reverse()
        extend(best_frame + 1, nf, bins)

        if len(bins) < filter_short:
            continue
        arr = np.asarray(bins)
        contours.append(Contour(
            pitch_mean=float(arr[:, 0].mean()),
            pitch_std_dev=float(arr[:, 0].std()),
            salience_mean=float(arr[:, 1].mean()),
            salience_std_dev=float(arr[:, 1].std()),
            start_frame=int(start_frame), bins=arr))

    if not contours:
        return []
    max_sal = max(c.salience_mean for c in contours)
    return [c for c in contours if c.salience_mean >= max_sal / filter_quiet]


def prism(self, prism_func, use_local_contour_time: bool = True):
    """Per-contour per-harmonic magnitude/frequency rewriting
    (reference PVInformation.cpp:265-421). prism_func(note_index, time,
    harmonic, base_freq, harmonic_mags) -> (mag, freq); harmonic_mags is
    the np array of all harmonic magnitudes for the frame.

    Each contour's frames are analyzed and rewritten as batched array ops
    over [contour-frames, harmonics, 21-bin windows]; the only per-entry
    Python work is the user callback, which is invoked once per
    contour-frame with the harmonic axis vectorized (scalar-only callbacks
    are retried per harmonic). Contours are processed in the reference's
    sorted order and a contour's frames are all distinct, so the batched
    writes reproduce the sequential loop's semantics exactly
    (PVInformation.cpp:332-368) - asserted against the scalar reference
    loop in tests.
    """
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    min_frequency, max_frequency = 55.0, 1760.0
    # reference get_height() is bin_to_frequency(num_bins) — one PAST the
    # last bin (PVBuffer.cpp:391-393), golden-tested via algo_prism_*
    height = self.bin_to_frequency(self.num_bins)
    b_cnt = self.num_bins
    bin_width = self.bin_width

    # one device->host pull per plane; out starts as a host copy of src
    src_mag = np.asarray(self.mag)
    src_freq = np.asarray(self.freq)
    out_mag = src_mag.copy()
    out_freq = src_freq.copy()

    for channel in range(self.num_channels):
        contours = get_contours(self, channel, min_frequency, max_frequency,
                                60, 20.0)
        if not contours:
            # reference parity: ANY channel without contours nulls the
            # whole call (PVInformation.cpp:299 'if (contours.empty())
            # return PV()'), discarding already-rewritten channels
            return PV.create_null()
        contours.sort(key=lambda c: c.start_frame)

        for ci, contour in enumerate(contours):
            _prism_one_contour(self, prism_func, use_local_contour_time,
                               channel, ci, contour, src_mag, src_freq,
                               out_mag, out_freq, min_frequency, height,
                               b_cnt, bin_width)

    return self._with(mag=jnp.asarray(out_mag), freq=jnp.asarray(out_freq))


def _prism_one_contour(self, prism_func, use_local_contour_time, channel,
                       ci, contour, src_mag, src_freq, out_mag, out_freq,
                       min_frequency, height, b_cnt, bin_width):
        # ---- flatten this contour's frames into entry arrays ----
        frames, cfs, approxs = [], [], []
        for cf in range(len(contour.bins)):
            frame = contour.start_frame + cf
            if 0 <= frame < self.num_frames:
                frames.append(frame)
                cfs.append(cf)
                approxs.append(
                    min_frequency * 2.0 ** (contour.bins[cf][0] / 120.0))
        if not frames:
            return
        fr_idx = np.asarray(frames, np.int64)
        approx = np.asarray(approxs, np.float64)

        # ---- batched base-frequency estimate (PVInformation.cpp:300-318) --
        mg = src_mag[channel][fr_idx]                 # [M, B]
        fq = src_freq[channel][fr_idx]
        # ratios evaluate in float32, matching the scalar path's
        # f32-array / python-float promotion, so borderline threshold
        # comparisons resolve identically
        ratio_a = fq / approx.astype(np.float32)[:, None]
        close = ((fq > 0.01)
                 & (ratio_a > _NOTES_CLOSE_LO)
                 & (ratio_a < _NOTES_CLOSE_HI))
        # accumulate in float32 like the scalar/reference path so borderline
        # ratio/threshold comparisons resolve identically
        w = np.where(close, np.abs(mg), np.float32(0.0)).astype(np.float32)
        tot = w.sum(axis=-1, dtype=np.float32)
        base = np.where(
            tot > 0,
            (fq * w).sum(axis=-1, dtype=np.float32)
            / np.maximum(tot, np.float32(1e-30)), np.float32(0.0)
        ).astype(np.float64)
        # harmonic count floors the FLOAT32 quotient (size_t of
        # std::floor(get_height()/base_freq), PVInformation.cpp:314)
        nharm = np.where(base >= 1.0,
                         (np.float32(height)
                          / np.maximum(base, 1e-9).astype(np.float32))
                         .astype(np.int64), 0)
        keep = np.nonzero((tot > 0) & (base >= 1.0) & (nharm >= 1))[0]
        if keep.size == 0:
            return
        fr_idx, base, nharm = fr_idx[keep], base[keep], nharm[keep]
        mg, fq = mg[keep], fq[keep]
        cfs_k = [cfs[i] for i in keep]
        m_cnt = keep.size
        h_max = int(nharm.max())            # derived from the data, no cap

        # ---- batched harmonic windows/selection (the former inner loops) -
        # All decision arithmetic runs in FLOAT32 like the reference's
        # Frequency/fBin types (PVInformation.cpp:324-336): harmonic freq
        # base*(h+1), its bin truncation, and the half-note ratio bounds —
        # f64 here moves truncation/threshold boundaries (golden-tested)
        h = np.arange(1, h_max + 1, dtype=np.float32)
        bwd32 = np.float32(bin_width)
        f_h = base.astype(np.float32)[:, None] * h[None, :]  # [M, H] f32
        hvalid = h[None, :] <= nharm[:, None]
        c_bin = (f_h / bwd32).astype(np.int32)           # trunc, as Bin()
        offs = np.arange(-10, 11, dtype=np.int32)
        wb = c_bin[:, :, None] + offs[None, None, :]     # [M, H, 21]
        vb = (wb >= 0) & (wb < b_cnt) & hvalid[:, :, None]
        wbc = np.clip(wb, 0, b_cnt - 1)
        m_ix = np.arange(m_cnt)[:, None, None]
        wf = fq[m_ix, wbc]                               # [M, H, 21]
        wm = mg[m_ix, wbc]
        f_h32 = np.maximum(f_h, np.float32(1e-30))
        ratio = wf / f_h32[:, :, None]                   # f32, as scalar path
        sel = (vb & (wf > 0.01)
               & (ratio > np.float32(_NOTES_CLOSE_LO))
               & (ratio < np.float32(_NOTES_CLOSE_HI)))

        fidx3 = np.broadcast_to(fr_idx[:, None, None], wb.shape)
        out_mag[channel][fidx3[sel], wbc[sel]] = 0.0     # zeroing pass

        wm_sel = np.where(sel, wm, -np.inf)
        arg = wm_sel.argmax(axis=-1)                     # [M, H]
        any_sel = sel.any(axis=-1)
        max_bins = np.take_along_axis(
            wbc, arg[:, :, None], axis=-1)[:, :, 0]
        mm_raw = np.take_along_axis(wm, arg[:, :, None], axis=-1)[:, :, 0]
        max_mags = np.where(any_sel & (mm_raw >= 0.01), mm_raw, 0.0)
        max_bins = np.where(any_sel, max_bins, 0)

        # ---- user callback, one call per entry (harmonics vectorized) ----
        new_m = np.zeros((m_cnt, h_max), np.float64)
        new_f = np.full((m_cnt, h_max), -1.0, np.float64)
        for i in range(m_cnt):
            hn = int(nharm[i])
            t_arg = self.frame_to_time(
                cfs_k[i] if use_local_contour_time else int(fr_idx[i]))
            hm = max_mags[i, :hn].astype(np.float32)
            try:
                rm, rf = prism_func(ci, t_arg,
                                    np.arange(1, hn + 1), float(base[i]),
                                    hm)
                rm = np.broadcast_to(
                    np.asarray(rm, np.float64).reshape(-1), (hn,))
                rf = np.broadcast_to(
                    np.asarray(rf, np.float64).reshape(-1), (hn,))
            except Exception:
                rm = np.empty(hn)
                rf = np.empty(hn)
                for hh in range(hn):
                    rm[hh], rf[hh] = prism_func(ci, t_arg, hh + 1,
                                                float(base[i]), hm)
            new_m[i, :hn] = rm
            new_f[i, :hn] = rf

        # ---- batched shifted-copy writes (max-magnitude combine) ---------
        # target-bin/scale arithmetic in FLOAT32 (the reference's MF and
        # Frequency fields are floats; PVInformation.cpp:382-386)
        wh = hvalid & (max_mags != 0) & (new_f >= 0)
        f_h_safe = np.maximum(f_h, np.float32(1e-30))    # f32 [M, H]
        nf32 = new_f.astype(np.float32)
        nm32 = new_m.astype(np.float32)
        new_max_bin = (nf32 / f_h_safe
                       * max_bins.astype(np.float32)).astype(np.int64)
        shift = new_max_bin - max_bins
        nb = wb + shift[:, :, None]
        ok = sel & wh[:, :, None] & (nb >= 0) & (nb < b_cnt)
        m_scale = np.where(
            max_mags != 0,
            nm32 / np.maximum(max_mags, 1e-30).astype(np.float32),
            np.float32(0.0)).astype(np.float32)
        sm = wm * m_scale[:, :, None]
        smf = wf * (nf32 / f_h_safe)[:, :, None]
        # ---- batched hann-bump paint where no harmonic energy existed ----
        # bounds via f32 frequency_to_bin: low = max(0, ceil), high =
        # min(bins-1, floor) (PVInformation.cpp:403-414); the ceil/floor
        # inputs must round like the reference's f32 divisions
        wp = hvalid & (max_mags == 0) & (new_f >= 0)
        bw32 = np.float32(10.0)
        lo_f = nf32 - np.float32(5.0)
        hi_f = nf32 + np.float32(5.0)
        w2 = int(10.0 / bin_width) + 2
        pofs = np.arange(w2, dtype=np.int64)
        lo_bin = np.maximum(
            0, np.ceil(lo_f / bwd32).astype(np.int64))
        hi_bin = np.minimum(
            b_cnt - 1, np.floor(hi_f / bwd32).astype(np.int64))
        pb = lo_bin[:, :, None] + pofs[None, None, :]       # [M, H, W2]
        okp = wp[:, :, None] & (pb <= hi_bin[:, :, None])
        pos = (pb.astype(np.float32) * bwd32 - lo_f[:, :, None]) / bw32
        pval = nm32[:, :, None] * np.float32(0.5) * (
            np.float32(1.0) - np.cos(np.float32(2.0 * np.pi) * pos))
        fidx3p = np.broadcast_to(fr_idx[:, None, None], pb.shape)
        pbc = np.clip(pb, 0, b_cnt - 1)

        # Writes apply harmonic-by-harmonic (each step batched over all
        # entries and window taps) to preserve the reference's in-frame
        # ordering between max-combine copies and unconditional paints of
        # different harmonics (PVInformation.cpp:332-368).
        for hh in range(h_max):
            sel_h = ok[:, hh, :]
            if sel_h.any():
                fi = fidx3[:, hh, :][sel_h]
                bi = nb[:, hh, :][sel_h]
                vals = sm[:, hh, :][sel_h].astype(np.float32)
                vfs = smf[:, hh, :][sel_h]
                # the scalar loop writes freq only on STRICT improvement
                # (reference 'if out < sm', PVInformation.cpp:350), so ties
                # with the existing value - notably zero-magnitude taps on
                # zero bins - must not touch freq; among equal in-batch
                # candidates the first wins (reversed write order)
                prev = out_mag[channel][fi, bi].copy()
                np.maximum.at(out_mag[channel], (fi, bi), vals)
                winners = (vals > prev) & (out_mag[channel][fi, bi] == vals)
                wi = np.flatnonzero(winners)[::-1]
                out_freq[channel][fi[wi], bi[wi]] = vfs[wi]
            selp_h = okp[:, hh, :]
            if selp_h.any():
                fip = fidx3p[:, hh, :][selp_h]
                bip = pbc[:, hh, :][selp_h]
                out_mag[channel][fip, bip] = \
                    pval[:, hh, :][selp_h].astype(np.float32)
                out_freq[channel][fip, bip] = np.broadcast_to(
                    new_f[:, hh, None],
                    pb[:, hh, :].shape)[selp_h].astype(np.float32)


def _prism_scalar_reference(self, prism_func,
                            use_local_contour_time: bool = True):
    """The original per-bin scalar rewrite loop, kept as the equivalence
    oracle for the batched prism above (tests/test_pv_information.py).
    Mirrors the reference's sequential control flow exactly
    (PVInformation.cpp:265-421)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    min_frequency, max_frequency = 55.0, 1760.0
    # get_height() is bin_to_frequency(num_bins) — one PAST the last bin
    # (PVBuffer.cpp:391-393)
    height = self.bin_to_frequency(self.num_bins)
    b_cnt = self.num_bins

    src_mag = np.asarray(self.mag)
    src_freq = np.asarray(self.freq)
    out_mag = src_mag.copy()
    out_freq = src_freq.copy()

    for channel in range(self.num_channels):
        contours = get_contours(self, channel, min_frequency, max_frequency,
                                60, 20.0)
        if not contours:
            return PV.create_null()
        contours.sort(key=lambda c: c.start_frame)
        for ci, contour in enumerate(contours):
            for cf in range(len(contour.bins)):
                frame = contour.start_frame + cf
                if frame < 0 or frame >= self.num_frames:
                    continue
                approx = min_frequency * 2.0 ** (
                    contour.bins[cf][0] / 120.0)
                fr = src_freq[channel, frame]
                mg = src_mag[channel, frame]
                close = (fr > 0.01) & (fr / approx > _NOTES_CLOSE_LO) \
                    & (fr / approx < _NOTES_CLOSE_HI)
                # masked full-row sums (not compacted-array sums) so the
                # pairwise-summation tree matches the batched prism's
                # bit-for-bit; numpy rounds the two forms differently,
                # which flips ceil/threshold decisions at exact bin edges
                wmask = np.where(close, np.abs(mg),
                                 np.float32(0.0)).astype(np.float32)
                tot = wmask.sum(dtype=np.float32)
                if tot == 0:
                    continue
                base = float((fr * wmask).sum(dtype=np.float32) / tot)
                if base < 1.0:
                    continue
                # FLOAT32 decision arithmetic throughout, matching the
                # reference's Frequency/fBin float types (golden-tested)
                nharm = int(np.float32(height) / np.float32(base))
                if nharm < 1:
                    continue

                bins_to_change = []
                for h in range(nharm):
                    f_h = np.float32(base) * np.float32(h + 1)
                    c_bin = f_h / np.float32(self.bin_width)
                    lo = int(np.clip(c_bin - 10, 0, b_cnt - 1))
                    hi = int(np.clip(c_bin + 10, 0, b_cnt - 1))
                    window = np.arange(lo, hi + 1)
                    wf = fr[window]
                    sel = (wf > 0.01) \
                        & (wf / f_h > np.float32(_NOTES_CLOSE_LO)) \
                        & (wf / f_h < np.float32(_NOTES_CLOSE_HI))
                    bins = window[sel]
                    bins_to_change.append(bins)
                    out_mag[channel, frame, bins] = 0.0

                max_bins = np.zeros(nharm, np.int64)
                max_mags = np.zeros(nharm, np.float32)
                for h in range(nharm):
                    bins = bins_to_change[h]
                    if len(bins) == 0:
                        continue
                    mb = bins[mg[bins].argmax()]
                    max_bins[h] = mb
                    mm = mg[mb]
                    max_mags[h] = mm if mm >= 0.01 else 0.0

                t_arg = self.frame_to_time(
                    cf if use_local_contour_time else frame)
                for h in range(nharm):
                    f_h = np.float32(base) * np.float32(h + 1)
                    new_m, new_f = prism_func(ci, t_arg, h + 1, base,
                                              max_mags)
                    if new_f < 0:
                        continue
                    nf32 = np.float32(new_f)
                    nm32 = np.float32(new_m)
                    if max_mags[h] != 0:
                        bins = bins_to_change[h]
                        new_max_bin = int(nf32 / f_h
                                          * np.float32(max_bins[h]))
                        shift = new_max_bin - max_bins[h]
                        f_scale = nf32 / f_h
                        m_scale = nm32 / max_mags[h]
                        nb = bins + shift
                        ok = (nb >= 0) & (nb < b_cnt)
                        for bsrc, bdst in zip(bins[ok], nb[ok]):
                            sm = mg[bsrc] * m_scale
                            if out_mag[channel, frame, bdst] < sm:
                                out_mag[channel, frame, bdst] = sm
                                out_freq[channel, frame, bdst] = \
                                    fr[bsrc] * f_scale
                    else:
                        bw32 = np.float32(10.0)
                        lo_f = nf32 - np.float32(5.0)
                        hi_f = nf32 + np.float32(5.0)
                        bwd32 = np.float32(self.bin_width)
                        lo = int(max(0, math.ceil(lo_f / bwd32)))
                        hi = int(min(b_cnt - 1,
                                     math.floor(hi_f / bwd32)))
                        for bdst in range(lo, hi + 1):
                            pos = (np.float32(bdst) * bwd32 - lo_f) / bw32
                            out_mag[channel, frame, bdst] = nm32 * (
                                np.float32(0.5)
                                * (np.float32(1.0)
                                   - np.cos(np.float32(2.0 * math.pi)
                                            * pos)))
                            out_freq[channel, frame, bdst] = nf32
    return self._with(mag=jnp.asarray(out_mag), freq=jnp.asarray(out_freq))
