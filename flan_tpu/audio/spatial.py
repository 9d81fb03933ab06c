"""Audio spatial methods: pan, widen, psychoacoustic stereo spatialization.

JAX re-design of the reference spatial family
(reference: src/flan/Audio/AudioSpatial.cpp). The reference's blockwise
WDL-resampler ITD/doppler path becomes an inverse-mapped fractional-delay
gather: emission times are monotonic when the source is speed-limited below
the speed of sound, so each output sample reads one interpolated input
position. Attached to Audio in flan_tpu.audio.__init__.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from flan_tpu.func import interpolators
from flan_tpu.func.function import as_function
from flan_tpu.ops.resample import fractional_gather

SOUND_MPS = 343.0  # speed of sound (reference AudioSpatial.cpp:7)


def pan(self, pan_position):
    """Constant-power sin/cos stereo pan (reference
    AudioSpatial.cpp:9-40); mono is upmixed first."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if self.num_channels not in (1, 2):
        return Audio.create_null()
    out = self.convert_to_stereo() if self.num_channels == 1 else self
    fn = as_function(pan_position)
    t = jnp.arange(out.num_frames, dtype=jnp.float32) / out.sample_rate
    p = jnp.broadcast_to(jnp.asarray(fn(t), jnp.float32),
                         (out.num_frames,)) / 2.0 + 0.5
    left = interpolators.sine2(p)
    right = interpolators.sine2(1.0 - p)
    return out._with(data=out.data * jnp.stack([left, right]))


def widen(self, widen_amount):
    """Mid/side energy redistribution (reference AudioSpatial.cpp:42-45)."""
    return pan(self.convert_to_mid_side(),
               widen_amount).convert_to_left_right()


def _speed_limit_positions(ps: np.ndarray, limit_per_frame: np.ndarray
                           ) -> np.ndarray:
    """Clamp per-frame movement magnitude (reference
    AudioSpatial.cpp:237-257). Cumulative, so host-side; skipped entirely
    when no frame exceeds the limit."""
    deltas = np.diff(ps, axis=0)
    mags = np.linalg.norm(deltas, axis=-1)
    if not (mags > limit_per_frame[1:]).any():
        return ps
    out = ps.copy()
    for i in range(1, len(ps)):
        mv = ps[i] - out[i - 1]
        mag = float(np.linalg.norm(mv))
        lim = limit_per_frame[i]
        if mag > lim:
            out[i] = out[i - 1] + mv / mag * lim
        else:
            out[i] = ps[i]
    return out


def _head_ild(audio, rel_pos: np.ndarray, ear_direction: float):
    """ILD: 500 Hz one-pole lowpass mixed by cos of the angle away from
    the ear axis (reference head_ild, AudioSpatial.cpp:116-131)."""
    angle = np.arctan2(rel_pos[:, 1], rel_pos[:, 0]) - ear_direction
    mix = jnp.asarray(0.5 + 0.5 * np.cos(angle), jnp.float32)
    low = audio.filter_1pole_lowpass(500.0, 1)
    data = low.data * (1.0 - mix)[None, :] + audio.data * mix[None, :]
    return audio._with(data=data)


def _wdl_feed_plan(num_frames: int, gran: int, stretches, num_out: int):
    """Host simulation of the reference head_itd feed-mode WDL loop
    (AudioSpatial.cpp:190-219 driving WDL resample.cpp with
    SetMode(true, 0, true, 32) + SetFeedMode(true)): each iteration
    feeds exactly `gran` input frames and emits up to ceil(gran*stretch)
    outputs, stopping when the 32-tap sinc window runs off the buffered
    input. SincSample1's two-slice blend reads buffer position
    ipos + frac + 15, so global position win + srcpos + 15. When the
    ratio is exactly integer (stretch == 1 chunks) WDL collapses the
    oversampled bank to one table (isideal) and quantizes fracpos to
    that grid (resample.cpp:1562-1563) — reproduced here; the
    integer-sample-rate GCD branch is unreachable for the irrational
    stretches this caller produces.

    Returns (positions, rates) float64 [num_out]; sentinel -1e9 marks
    never-written frames (the reference's zero-cleared output buffer).
    """
    SINC, HFS = 32, 16
    pos = np.full(num_out, -1e9, np.float64)
    rate = np.ones(num_out, np.float64)
    samples_in = 0
    fracpos = 0.0
    win = 0
    out_frame = 0
    for in_frame in range(0, num_frames, gran):
        stretch = float(stretches[in_frame // gran])
        ratio = 1.0 / stretch
        if samples_in < HFS - 1:
            win -= (HFS - 1) - samples_in
            samples_in = HFS - 1
        samples_in += gran          # feed mode: sreq == out_samples
        filtlen = samples_in - SINC
        if ratio >= 1.0:
            ideal = float(int(ratio + 0.5)) == ratio
            oversize = 1 if ideal else 32
        else:
            drat = 1.0 / ratio
            irat = int(drat + 0.5)
            ideal = irat > 1 and float(irat) == drat and irat <= 64
            oversize = irat if ideal else 32
        srcpos = fracpos
        ret = 0
        for _ in range(int(math.ceil(gran * stretch))):
            ipos = int(srcpos)
            if ipos >= filtlen - 1:
                break
            if out_frame + ret < num_out:
                f = srcpos - ipos
                if ideal:
                    f = math.floor(f * oversize + 0.5) / oversize
                pos[out_frame + ret] = win + ipos + f + (HFS - 1)
                rate[out_frame + ret] = ratio
            srcpos += ratio
            ret += 1
        out_frame += ret
        isrcpos = int(srcpos)
        if isrcpos > samples_in:
            isrcpos = samples_in
        fracpos = srcpos - isrcpos
        if ideal:
            fracpos = math.floor(oversize * fracpos + 0.5) / oversize
        samples_in -= isrcpos
        if samples_in < 0:
            samples_in = 0
        win += isrcpos
    return pos, rate


def _head_itd(audio, rel_pos: np.ndarray):
    """ITD + doppler (reference head_itd, AudioSpatial.cpp:135-221).

    Two documented reference quirks are preserved: (1) for a MOVING
    source the initial propagation delay is computed but never applied
    (`initial_delay_frames` is a dead variable at AudioSpatial.cpp:180
    — only the differential doppler stretch is rendered, from output
    frame 0), while a CONSTANT position takes the integer-delay branch
    (:139-153) and IS delayed; (2) the output buffer length still
    reserves room for the unapplied delay
    (frame_to_time(chunk_end) + dist/c, :168), leaving a zero tail.
    The per-chunk stretch plan is simulated on host (_wdl_feed_plan)
    and rendered as one fractional-sinc gather on device."""
    sr = audio.sample_rate
    n = audio.num_frames
    dist = np.linalg.norm(rel_pos, axis=-1)
    if np.all(dist == dist[0]):
        # constant-position branch: integer frame delay, no resampling
        d = int(dist[0] / SOUND_MPS * sr)
        pad = jnp.zeros((audio.num_channels, d), audio.data.dtype)
        return audio._with(data=jnp.concatenate([pad, audio.data], axis=-1))

    GRAN = 32
    changes = [0.0]     # no movement assumed on frame 0
    prev = float(dist[0])
    max_needed = 0.0
    for f in range(GRAN, n, GRAN):
        cur = float(dist[f])
        changes.append(cur - prev)
        prev = cur
        max_needed = max(max_needed, (f + GRAN) / sr + cur / SOUND_MPS)
    num_out = int(math.ceil(max_needed * sr))
    stretches = [1.0 / (1.0 - ch / GRAN / SOUND_MPS * sr)
                 for ch in changes]
    pos, rate = _wdl_feed_plan(n, GRAN, stretches, num_out)
    # WDL anti-alias margin when reading faster than 1x
    cutoff = np.where(rate > 1.0, 1.0 / (1.03 * rate), 1.0)
    out = fractional_gather(audio.data, jnp.asarray(pos, jnp.float32),
                            jnp.asarray(cutoff, jnp.float32), num_taps=32)
    return audio._with(data=out.astype(jnp.float32))


def stereo_spatialize(self, position, head_width: float = 0.18,
                      speed_limit=None):
    """Psychoacoustic 2-D spatialization of a mono source: per-ear ILD,
    distance falloff, and ITD/doppler (reference
    AudioSpatial.cpp:223-281)."""
    from flan_tpu.audio.audio import Audio
    if self.num_channels != 1:
        return Audio.create_null()
    n = self.num_frames
    sr = self.sample_rate

    pos_fn = position if callable(position) else None
    if pos_fn is None:
        ps = np.tile(np.asarray(position, np.float64)[None, :], (n, 1))
    else:
        t = np.arange(n, dtype=np.float64) / sr
        raw = [np.asarray(pos_fn(float(tt)), np.float64) for tt in
               t[:: max(1, n // 4096)]]
        # sample at reduced control rate then lerp up (positions are smooth)
        ctrl = np.stack(raw)
        ctrl_t = t[:: max(1, n // 4096)]
        ps = np.stack([np.interp(t, ctrl_t, ctrl[:, d])
                       for d in range(ctrl.shape[1])], axis=-1)
        eps = 1.0
        if speed_limit is None:
            lim = np.full(n, (SOUND_MPS - eps) / sr)
        else:
            lim_fn = as_function(speed_limit)
            lim = np.clip(_np_sample(lim_fn, n, 1.0 / sr), 0.0,
                          SOUND_MPS - eps) / sr
        ps = _speed_limit_positions(ps, lim)

    ears = []
    for is_left, direction in ((True, 75.0 * 2 * math.pi / 360.0),
                               (False, -75.0 * 2 * math.pi / 360.0)):
        ear_pos = np.array([0.0, (1.0 if is_left else -1.0)
                            * head_width / 2.0])
        rel = ps - ear_pos[None, :]
        buf = _head_ild(self, rel, direction)
        dist = np.linalg.norm(rel, axis=-1)
        gain = jnp.asarray(1.0 / (dist + 1e-5), jnp.float32)
        buf = buf._with(data=buf.data * gain[None, :])
        ears.append(_head_itd(buf, rel))

    return Audio.combine_channels(ears)


def _np_sample(fn, count, period):
    if fn.is_constant:
        return np.full(count, fn.constant_value, np.float64)
    grid = jnp.arange(count, dtype=jnp.float32) * period
    return np.asarray(fn(grid), np.float64).reshape(-1)


def filter_pinna(self, height):
    """Approximate pinna (outer-ear-flap) elevation filtering for a
    source one meter away, activated from the reference's commented
    implementation (AudioSpatial.cpp:69-84): the elevation angle
    atan(height) drives three band shelves — the main 8 kHz shelf gain
    is -5 + angle/(pi/2) * 10 dB (so -15 dB far below, -5 dB at ear
    level, +5 dB far above — the reference's own asymmetric curve), a
    thin 10 kHz shelf at 0.8x that gain and a broad 3.5 kHz shelf at
    0.1x (damping values from the reference's qr = 1/2 note)."""
    from flan_tpu.audio import filters as _filters
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    h_fn = as_function(height)
    if h_fn.is_constant:
        g = float(-5.0 + math.atan(float(h_fn.constant_value))
                  / (math.pi / 2) * 10.0)
        main, thin, broad = g, 0.8 * g, 0.1 * g
    else:
        def main(t):
            h = jnp.asarray(h_fn(t), jnp.float32)
            return -5.0 + jnp.arctan(h) / (math.pi / 2) * 10.0

        def thin(t):
            return main(t) * 0.8

        def broad(t):
            return main(t) * 0.1

    out = _filters.filter_2pole_bandshelf(self, 8000.0, 0.25, main)
    out = _filters.filter_2pole_bandshelf(out, 10000.0, 0.03, thin)
    return _filters.filter_2pole_bandshelf(out, 3500.0, 0.7, broad)
