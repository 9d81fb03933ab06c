"""Audio temporal methods: boundaries, cuts, silence, splits, repitch.

JAX re-design of the reference's temporal family
(reference: src/flan/Audio/AudioTemporal.cpp). Attached to Audio as methods
in flan_tpu.audio.__init__.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func import interpolators
from flan_tpu.func.function import as_function
from flan_tpu.ops import resample as resample_ops


def modify_boundaries_frames(self, start: int, end: int):
    """Pad/trim both ends: output covers [start, num_frames + end)
    (reference AudioTemporal.cpp:96-114)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    num_out = -start + self.num_frames + end
    if num_out <= 0:
        return Audio.create_null()
    out = jnp.zeros((self.num_channels, num_out), jnp.float32)
    src_lo = max(start, 0)
    src_hi = min(self.num_frames, num_out + start)
    if src_hi > src_lo:
        dst_lo = src_lo - start
        out = out.at[:, dst_lo:dst_lo + (src_hi - src_lo)].set(
            self.data[:, src_lo:src_hi])
    return self._with(data=out)


def modify_boundaries(self, start: float, end: float):
    return modify_boundaries_frames(self, self.time_to_frame(start),
                                    self.time_to_frame(end))


def cut_frames(self, start: int, end: int, start_fade: int = 0,
               end_fade: int = 0):
    """Keep [start, end) with sqrt fades (reference
    AudioTemporal.cpp:207-234)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if end <= start:
        return Audio.create_null()
    start = int(np.clip(start, 0, self.num_frames - 1))
    end = int(np.clip(end, 0, self.num_frames - 1))
    if end <= start:
        return Audio.create_null()
    out = self._with(data=self.data[:, start:end])
    return fade_frames(out, start_fade, end_fade, interpolators.sqrt)


def cut(self, start: float, end: float, start_fade: float = 0.0,
        end_fade: float = 0.0):
    return cut_frames(self, self.time_to_frame(start),
                      self.time_to_frame(end),
                      self.time_to_frame(start_fade),
                      self.time_to_frame(end_fade))


def fade_frames(self, start: int = 16, end: int = 16,
                interp=interpolators.sqrt):
    """Fade ends in place of the reference's fade_frames
    (reference AudioVolume.cpp fades; sqrt default for constant power)."""
    if self.is_null():
        return self
    n = self.num_frames
    start = int(np.clip(start, 0, n))
    end = int(np.clip(end, 0, n))
    if start + end > n:
        # shrink proportionally like the reference's validation
        scale = n / (start + end)
        start = int(start * scale)
        end = n - start
    env = jnp.ones((n,), jnp.float32)
    if start > 0:
        ramp = interp(jnp.arange(start, dtype=jnp.float32) / start)
        env = env.at[:start].set(ramp)
    if end > 0:
        ramp = interp(jnp.arange(end, dtype=jnp.float32) / end)
        env = env.at[n - end:].set(ramp[::-1])
    return self._with(data=self.data * env[None, :])


def fade(self, start: float = 16.0 / 48000.0, end: float = 16.0 / 48000.0,
         interp=interpolators.sqrt):
    return fade_frames(self, self.time_to_frame(start),
                       self.time_to_frame(end), interp)


def _noisy_mask(self, non_silent_level: float) -> np.ndarray:
    """Host-side per-frame 'any channel above level' mask
    (reference's noisy-frame test, AudioTemporal.cpp:24-39)."""
    return np.asarray(
        jnp.any(self.data > non_silent_level, axis=0))


def remove_edge_silence(self, non_silent_level: float,
                        fade_in_time: float = 0.0):
    """(reference AudioTemporal.cpp:124-153)"""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    mask = _noisy_mask(self, non_silent_level)
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return Audio.create_null()
    start_frame, end_frame = int(idx[0]), int(idx[-1]) + 1
    fade_frames_n = self.time_to_frame(fade_in_time)
    start_fade = min(start_frame, fade_frames_n)
    end_fade = min(self.num_frames - end_frame, fade_frames_n)
    return cut_frames(self, start_frame - fade_frames_n,
                      end_frame + fade_frames_n, start_fade, end_fade)


def _loud_chunk_bounds(self, non_silent_level: float, minimum_gap: float
                       ) -> List[tuple]:
    """Find [start, last_noisy] spans separated by > gap quiet frames
    (reference get_loud_chunks_base, AudioTemporal.cpp:10-50)."""
    mask = _noisy_mask(self, non_silent_level)
    gap_frames = self.time_to_frame(minimum_gap)
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return []
    # split where the gap between consecutive noisy frames exceeds gap
    splits = np.nonzero(np.diff(idx) > gap_frames)[0]
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]])
    bounds = list(zip(starts.tolist(), (ends + 1).tolist()))
    # the reference extends the final chunk to the buffer end when the file
    # ends while still noisy (AudioTemporal.cpp:47-48)
    if len(bounds) > 0 and self.num_frames - bounds[-1][1] <= gap_frames:
        bounds[-1] = (bounds[-1][0], self.num_frames)
    return bounds


def get_loud_chunks(self, non_silent_level: float, minimum_gap: float,
                    fade_in_time: float = 0.0):
    bounds = _loud_chunk_bounds(self, non_silent_level, minimum_gap)
    fade_n = self.time_to_frame(fade_in_time)
    chunks = []
    for (a, b) in bounds:
        lf = min(a, fade_n)
        rf = min(self.num_frames - b, fade_n)
        chunks.append(cut_frames(self, a - lf, b + rf, lf, rf))
    return chunks


def remove_silence(self, non_silent_level: float, minimum_gap: float,
                   fade_in_time: float = 0.0):
    """Join the loud chunks, overlapping fades
    (reference AudioTemporal.cpp:164-172)."""
    from flan_tpu.audio.audio import Audio
    chunks = get_loud_chunks(self, non_silent_level, minimum_gap,
                             fade_in_time)
    if not chunks:
        return Audio.create_null()
    return Audio.join(chunks, offset=-2.0 * fade_in_time)


def split_at_times(self, split_times: Sequence[float], fade: float = 0.0):
    """(reference AudioTemporal.cpp:409-438)"""
    if self.is_null():
        return []
    fade_n = self.time_to_frame(fade)
    frames = [0]
    for t in sorted(split_times):
        f = self.time_to_frame(t)
        if f <= 0:
            continue
        if f >= self.num_frames:
            break
        frames.append(f)
    frames.append(self.num_frames)
    return [cut_frames(self, a, b, fade_n, fade_n)
            for a, b in zip(frames, frames[1:])]


def split_with_lengths(self, split_lengths: Sequence[float],
                       fade: float = 0.0):
    lengths = [max(0.0, t) for t in split_lengths]
    return split_at_times(self, list(np.cumsum(lengths)), fade)


def split_with_equal_lengths(self, slice_length: float, fade: float = 0.0):
    if slice_length <= 0:
        return []
    count = int(math.ceil(self.length / slice_length))
    return split_with_lengths(self, [slice_length] * count, fade)


def rearrange(self, slice_length: float, fade: float = 0.0, *, seed=None):
    """Shuffle equal slices and re-join with crossfades
    (reference AudioTemporal.cpp:463-482). Randomness is an explicit seed
    (SURVEY.md section 7: reference uses wall-clock seeding)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    chops = split_with_equal_lengths(self, slice_length + fade, fade)
    if len(chops) < 2:
        return Audio.create_null()
    chops.pop()  # final slice usually isn't the correct length
    rng = np.random.default_rng(seed)
    rng.shuffle(chops)
    return Audio.join(chops, offset=-fade)


def random_chunks(self, length: float, chunk_length, fade=0.0, mod=None,
                  *, seed=None):
    """Random source chunks joined with crossfades
    (reference AudioTemporal.cpp:484-546)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null() or length <= 0:
        return Audio.create_null()
    chunk_fn = as_function(chunk_length)
    fade_fn = as_function(fade)
    sr = self.sample_rate
    total_frames = self.time_to_frame(length)

    # integrate 1/chunk_length over output frames to place chunk starts
    starts = [0]
    acc = 0.0
    frame = 0
    while frame < total_frames:
        cl = float(np.clip(_eval_scalar(chunk_fn, frame / sr),
                           32 / sr, max(self.length, 32 / sr)))
        step = int(np.clip(round(cl * sr), 32, total_frames))
        frame += step
        starts.append(min(frame, total_frames))
    sizes = np.diff(starts)
    fades = [float(max(0.0, _eval_scalar(fade_fn, s / sr))) for s in starts]

    rng = np.random.default_rng(seed)
    chunks = []
    for i, size in enumerate(sizes):
        desired = int(size + self.time_to_frame(
            (fades[i] + fades[i + 1]) / 2))
        if desired >= self.num_frames:
            start_frame = 0
        else:
            start_frame = int(rng.integers(0, self.num_frames - desired))
        chunk = cut_frames(self, start_frame, start_frame + desired,
                           self.time_to_frame(fades[i]),
                           self.time_to_frame(fades[i + 1]))
        if mod is not None:
            chunk = mod(chunk, starts[i] / sr)
        chunks.append(chunk)
    offsets = [-f for f in fades]
    return Audio.join(chunks, offsets=offsets)


def _eval_scalar(fn, t: float) -> float:
    v = fn(jnp.float32(t)) if not fn.is_constant else fn.constant_value
    return float(np.asarray(v).reshape(()))


def _wdl_sinc_plan(num_frames: int, gran: int, rates_inv: np.ndarray,
                   is_constant: bool):
    """Host simulation of the reference repitch feed loop
    (AudioTemporal.cpp:236-299 driving WDL resample.cpp Sinc mode,
    SetMode(true, 0, true, 64)).

    The WDL resampler is a streaming 64-tap sinc interpolator; the
    reference feeds it `gran`-output-frame blocks, selecting the rate by
    the FEED head (`in_frame`), which runs ahead of the read head by the
    buffer fill (~ratio*gran + 68 frames). Three behaviors fall out of
    that arithmetic and are reproduced exactly here: (1) the rate curve
    is applied shifted by the buffer lookahead, (2) the loop terminates
    when the feed head (not the read head) passes the input end, leaving
    the planned output tail at the zero-initialized buffer value, and
    (3) SincSample1's two-slice interpolation reads buffer position
    ipos + frac + (sinc/2 - 1), i.e. global position
    window_start + srcpos + 31 (slice s of the oversampled filter bank
    is centered at tap 32 - s/32; the ifpos/rem blend lands the center
    exactly at srcpos + 31).

    Returns (positions, rates): float64 [num_out] global input read
    positions (sentinel -1e9 for never-written frames -> the device
    gather reads all zeros there) and per-frame ratios (for the
    anti-alias cutoff 1/(1.03*ratio), WDL resample.cpp:1327).
    """
    SINC = 64
    HFS = SINC // 2
    nblocks = len(rates_inv)
    # Output length: ceil(float32_accumulate(1/factor) * gran)
    # (AudioTemporal.cpp:252, FunctionSample.h:136-147).
    if is_constant:
        acc = np.float32(rates_inv[0]) * np.float32(nblocks)
    else:
        acc = np.float32(0.0)
        for v in rates_inv:
            acc = np.float32(acc + np.float32(v))
    num_out = int(np.ceil(np.float32(acc * np.float32(gran))))

    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    # rsoutbuf is reused across blocks; frames past a short ResampleOut
    # keep the previous block's (or initial zero) contents
    buf_pos = np.full(gran, -1e9, np.float64)
    buf_rate = np.ones(gran, np.float64)

    samples_in = 0      # m_samples_in_rsinbuf
    fracpos = 0.0       # m_fracpos
    win = 0             # global input frame of buffer index 0
    in_frame = 0
    out_frame = 0
    while in_frame < num_frames:
        fi = min(int(in_frame / float(gran)), nblocks - 1)
        ratio = 1.0 / float(rates_inv[fi])   # m_ratio (double)
        # ResamplePrepare (resample.cpp:1218-1264): zero history pad
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        sreq = int(ratio * gran) + 4 + SINC - samples_in
        if sreq < 0:
            sreq = 0
        if sreq == 0:
            break   # rate too small to ever advance (reference hangs)
        samples_in += sreq   # full feed: nsamples_in == m_last_requested
        # ResampleOut sinc loop (resample.cpp:1313-1415)
        filtlen = samples_in - SINC
        srcpos = fracpos
        for j in range(gran):
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            buf_pos[j] = win + srcpos + (HFS - 1)
            buf_rate[j] = ratio
            srcpos += ratio
        ncopy = min(gran, num_out - out_frame)
        if ncopy > 0:
            pos[out_frame:out_frame + ncopy] = buf_pos[:ncopy]
            rate[out_frame:out_frame + ncopy] = buf_rate[:ncopy]
        out_frame += gran
        in_frame += sreq
        # post-loop bookkeeping (resample.cpp:1556-1570)
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return pos, rate


def repitch(self, factor, granularity: float = 0.001,
            quality: str = "sinc", num_taps: int = 64):
    """Time-varying repitch (WDL-resampler equivalent; reference
    AudioTemporal.cpp:236-299). The read-rate curve is sampled per
    granularity block, the WDL feed loop is simulated on host
    (_wdl_sinc_plan), then the output is one dense windowed-sinc gather
    on device (flan_tpu.ops.resample). num_taps=64 matches the
    reference's SetMode sinc size (golden-tested to ~79 dB; 32 taps
    measured 36 dB against the compiled reference on an 8x rate
    sweep)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gran = max(1, self.time_to_frame(granularity))
    fn = as_function(factor)
    nblocks = int(math.ceil(self.num_frames / gran))
    tgrid = np.arange(nblocks, dtype=np.float64) * granularity
    if fn.is_constant:
        fvals = np.full(nblocks, fn.constant_value, np.float32)
    else:
        fvals = np.asarray(fn(jnp.asarray(tgrid, jnp.float32)),
                           np.float32).reshape(-1)
    # reference clamps 1/factor to [1/1000, 1000] in float32
    # (AudioTemporal.cpp:247-249)
    rates_inv = np.clip((np.float32(1.0) / fvals).astype(np.float32),
                        np.float32(1.0 / 1000.0), np.float32(1000.0))

    positions, rates = _wdl_sinc_plan(self.num_frames, gran, rates_inv,
                                      fn.is_constant)
    # WDL's anti-alias margin: filtpos = 1/(ratio*1.03) when reading
    # faster than realtime (resample.cpp:1327)
    cutoff = np.where(rates > 1.0, 1.0 / (1.03 * rates), 1.0)

    if quality == "linear":
        pos = jnp.asarray(positions, jnp.float32)
        base = jnp.floor(pos).astype(jnp.int32)
        frac = (pos - base)[None, :]
        n = self.num_frames
        written = (positions > -1e8)[None, :]
        lo = jnp.take(self.data, jnp.clip(base, 0, n - 1), axis=-1)
        hi = jnp.take(self.data, jnp.clip(base + 1, 0, n - 1), axis=-1)
        data = jnp.where(written, lo * (1 - frac) + hi * frac, 0.0)
    else:
        data = resample_ops.fractional_gather(
            self.data, jnp.asarray(positions, jnp.float32),
            jnp.asarray(cutoff, jnp.float32), num_taps=num_taps)
    return self._with(data=data)


def delay(self, added_length: float, delay_time, decay=0.5, mod=None,
          *, seed: int = 0):
    """Volume-decaying delay via the texture engine with feedback
    (reference AudioTemporal.cpp:326-361)."""
    from flan_tpu.audio.audio import Audio
    from flan_tpu.audio.synthesis import texture
    if self.is_null():
        return Audio.create_null()
    added_length = max(0.0, added_length)
    length = self.length + added_length
    dt_fn = as_function(delay_time)
    decay_fn = as_function(decay)
    sr = self.sample_rate

    def scalar(fn, t):
        import numpy as _np
        return float(_np.asarray(fn(jnp.float32(t))).reshape(())) \
            if not fn.is_constant else fn.constant_value

    def events_per_second(t):
        dt = jnp.maximum(jnp.asarray(dt_fn(t), jnp.float32), 1.0 / sr)
        return 1.0 / dt

    def delay_mod(audio, t):
        if t == 0:
            return audio
        out = audio if mod is None else mod(audio, t)
        return out.modify_volume(scalar(decay_fn, t))

    return texture(self, length, events_per_second, 0.0, delay_mod,
                   mod_feedback=True, seed=seed)


def stereo_delay(self, length: float, l_time, r_time, decay):
    """Cross-feedback stereo delay, activated from the reference's
    commented implementation (AudioTemporal.cpp:363-408): two ring
    buffers of size max(delay) feed each other through the decay, and
    the output reads each buffer one full buffer-length late. Stereo
    input only (null otherwise), `length` is the OUTPUT length.

    The reference writes the left buffer before reading it for the
    right write, so with constant delays (delay == buffer size) the
    right channel cross-feeds the CURRENT left value: w_L[t] = x_L[t] +
    g[t] w_R[t-D_R]; w_R[t] = x_R[t] + g[t] w_L[t]; out = (w_L[t-D_L],
    w_R[t-D_R]). That collapses to two feedback combs solved here as
    block-reshaped linear recurrences (no per-sample scan). Time-varying
    delay times take a per-sample lax.scan that replicates the ring
    ordering literally.
    """
    from flan_tpu.audio.audio import Audio
    from flan_tpu.ops.scan import linear_recurrence
    if self.is_null() or self.num_channels != 2:
        return Audio.create_null()
    sr = self.sample_rate
    out_n = int(length * sr)
    if out_n <= 0:
        return Audio.create_null()
    lt_fn = as_function(l_time)
    rt_fn = as_function(r_time)
    g_fn = as_function(decay)

    def sample_np(fn):
        if fn.is_constant:
            return np.full(out_n, float(fn.constant_value), np.float64)
        t = jnp.arange(out_n, dtype=jnp.float32) / sr
        return np.broadcast_to(
            np.asarray(fn(t), np.float64).reshape(-1), (out_n,))

    lt_s = sample_np(lt_fn)
    rt_s = sample_np(rt_fn)
    lb = int(lt_s.max() * sr)     # Frame cast truncates (reference)
    rb = int(rt_s.max() * sr)
    if lb <= 0 or rb <= 0:
        return Audio.create_null()

    x = jnp.pad(self.data, [(0, 0), (0, max(0, out_n - self.num_frames))])
    x = x[:, :out_n]
    # decay samples are only used on device - build them there (CLAUDE.md
    # transfer rule); the delay TIMES legitimately need host numpy (they
    # size the ring buffers)
    g = g_fn.sample_device(out_n, 1.0 / sr)

    def shift(v, d):
        return jnp.pad(v, [(d, 0)])[:out_n]

    if lt_fn.is_constant and rt_fn.is_constant:
        # w_R[t] = (x_R + g x_L)[t] + g[t]^2 w_R[t - rb]: reshape time
        # into [ceil(n/rb), rb] and run the recurrence down the rows
        u_r = x[1] + g * x[0]
        m = -(-out_n // rb)
        pad = m * rb - out_n
        a = jnp.pad(g * g, [(0, pad)]).reshape(m, rb)
        b = jnp.pad(u_r, [(0, pad)]).reshape(m, rb)
        w_r = linear_recurrence(a, b, axis=0).reshape(-1)[:out_n]
        w_l = x[0] + g * shift(w_r, rb)
        out = jnp.stack([shift(w_l, lb), shift(w_r, rb)])
        return Audio(data=out.astype(jnp.float32), sample_rate=sr)

    # time-varying delays: literal ring-buffer scan (slow path)
    dl = np.minimum(np.maximum((lt_s * sr).astype(np.int64), 0), lb)
    dr = np.minimum(np.maximum((rt_s * sr).astype(np.int64), 0), rb)
    dl_j = jnp.asarray(dl, jnp.int32)
    dr_j = jnp.asarray(dr, jnp.int32)
    ts = jnp.arange(out_n, dtype=jnp.int32)

    def body(carry, inp):
        l_buf, r_buf = carry
        t, xl, xr, gt, dlt, drt = inp
        l_lead = jnp.mod(t, lb)
        r_lead = jnp.mod(t, rb)
        l_follow = jnp.mod(t + lb - dlt, lb)
        r_follow = jnp.mod(t + rb - drt, rb)
        out_l = l_buf[l_lead]
        out_r = r_buf[r_lead]
        l_buf = l_buf.at[l_lead].set(xl + r_buf[r_follow] * gt)
        r_buf = r_buf.at[r_lead].set(xr + l_buf[l_follow] * gt)
        return (l_buf, r_buf), (out_l, out_r)

    init = (jnp.zeros((lb,), jnp.float32), jnp.zeros((rb,), jnp.float32))
    _, (out_l, out_r) = jax.lax.scan(
        body, init, (ts, x[0], x[1], g, dl_j, dr_j))
    return Audio(data=jnp.stack([out_l, out_r]).astype(jnp.float32),
                 sample_rate=sr)


def iterate(self, n: int, crossfade_time: float = 0.0, mod=None,
            feedback: bool = False):
    """Repeat n times, optionally modding each iteration
    (reference AudioTemporal.cpp:301-324)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null() or n < 1:
        return Audio.create_null()
    if mod is None:
        return Audio.join([self] * n, offset=-crossfade_time)
    outs = []
    current = self
    for i in range(n):
        source = current if (feedback and i > 0) else self
        modded = mod(source, i * self.length)
        outs.append(modded)
        current = modded
    return Audio.join(outs, offset=-crossfade_time)
