"""Audio synthesis and granular engine.

JAX re-design of the reference synthesis family
(reference: src/flan/Audio/AudioSynthesis.cpp). Waveform phase accumulation
is a mod-1 associative scan; noise uses explicit jax.random keys (the
reference seeds from wall clock - SURVEY.md section 7 makes randomness
reproducible); grain scheduling integrates event rates on host (tiny control
data) and mixes grains with the batched mixer. Attached to Audio in
flan_tpu.audio.__init__.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import Function, as_function, waveforms
from flan_tpu.ops.resample import fractional_gather
from flan_tpu.ops.windows import hann


def _sample_fn(fn, count: int, period: float):
    f = as_function(fn)
    if f.is_constant:
        return np.full(count, f.constant_value, np.float64)
    grid = jnp.arange(count, dtype=jnp.float32) * period
    vals = np.asarray(f(grid), np.float64).reshape(-1)
    return np.broadcast_to(vals, (count,)) if vals.size == 1 else vals


def synthesize_waveform(waveform, length: float, freq,
                        sample_rate: float = 48000.0,
                        oversample: int = 16):
    """Waveform synthesis: phase = mod-1 scan of frequency at the
    oversampled rate, evaluate, then downsample
    (reference AudioSynthesis.cpp:25-69)."""
    from flan_tpu.audio.audio import Audio
    if oversample < 1 or length <= 0 or sample_rate <= 0:
        return Audio.create_null()
    out_frames = int(length * sample_rate)
    in_rate = sample_rate * oversample
    n_in = out_frames * oversample

    f = as_function(freq)
    if f.is_constant:
        inc = jnp.full((n_in,), f.constant_value / in_rate, jnp.float32)
    else:
        t = jnp.arange(n_in, dtype=jnp.float32) / in_rate
        inc = jnp.broadcast_to(jnp.asarray(f(t), jnp.float32),
                               (n_in,)) / in_rate
    inc = jnp.mod(inc, 1.0)
    # exclusive mod-1 scan (reference uses exclusive_scan with fmod)
    cycles = jax.lax.associative_scan(lambda a, b: jnp.mod(a + b, 1.0), inc)
    phases = jnp.concatenate([jnp.zeros((1,)), cycles[:-1]])

    wave_fn = as_function(waveform)
    samples = jnp.asarray(wave_fn(phases), jnp.float32)[None, :]
    over_audio = Audio(data=samples, sample_rate=in_rate)
    return over_audio.resample(sample_rate)


def synthesize_white_noise(length: float, sample_rate: float = 48000.0,
                           oversample: int = 16, *, seed: int = 0):
    """(reference AudioSynthesis.cpp:71-89)"""
    from flan_tpu.audio.audio import Audio
    if oversample < 1 or length <= 0 or sample_rate <= 0:
        return Audio.create_null()
    n = int(length * sample_rate * oversample)
    key = jax.random.PRNGKey(seed)
    data = jax.random.uniform(key, (1, n), jnp.float32, -1.0, 1.0)
    return Audio(data=data,
                 sample_rate=sample_rate * oversample).resample(sample_rate)


def synthesize_pink_noise(length: float, sample_rate: float = 48000.0,
                          num_rows: int = 128, *, seed: int = 0):
    """Voss-McCartney pink noise (reference AudioSynthesis.cpp:91-149).

    Vectorized: each row r holds at updates spaced 2^(r+1) frames apart;
    its piecewise-constant series is a repeat-expansion of per-update
    randoms, so the whole generator is a sum of log2(num_rows) expanded
    random sequences plus per-frame white noise - no sequential loop.
    """
    from flan_tpu.audio.audio import Audio
    if length <= 0 or sample_rate <= 0 or num_rows < 1:
        return Audio.create_null()
    n = int(length * sample_rate)
    key = jax.random.PRNGKey(seed)
    nbits = max(1, int(math.log2(max(num_rows, 2))))
    total = jnp.zeros((n,), jnp.float32)
    for r in range(nbits):
        stride = 1 << (r + 1)
        count = n // stride + 2
        key, sub = jax.random.split(key)
        vals = jax.random.uniform(sub, (count,), jnp.float32, -1.0, 1.0)
        series = jnp.repeat(vals, stride)[:n]
        total = total + series
    key, sub = jax.random.split(key)
    total = total + jax.random.uniform(sub, (n,), jnp.float32, -1.0, 1.0)
    audio = Audio(data=total[None, :], sample_rate=sample_rate)
    return audio.set_volume(1.0)


def synthesize_spectrum(length: float, freq, spread=None,
                        harmonic_scale=None, peak_distribution=None,
                        fundamental_power: int = 8,
                        spectrum_size_power: int = 20,
                        num_channels: int = 2,
                        granularity: float = 0.001, *, seed: int = 0,
                        sample_rate: float = 48000.0):
    """Giant-IFFT wavetable with per-harmonic spectral distributions,
    played back at variable rate (reference AudioSynthesis.cpp:151-268)."""
    from flan_tpu.audio.audio import Audio
    if (length <= 0 or fundamental_power <= 0 or spectrum_size_power <= 0
            or fundamental_power > spectrum_size_power or granularity <= 0
            or spectrum_size_power >= 32):
        return Audio.create_null()

    fundamental = float(2 ** fundamental_power)
    wavelength = 2 ** spectrum_size_power
    nbins = wavelength // 2 + 1

    spread_fn = as_function(spread if spread is not None
                            else (lambda h: h))
    scale_fn = as_function(harmonic_scale if harmonic_scale is not None
                           else (lambda h: 1.0 / jnp.sqrt(h)))
    dist_fn = as_function(
        peak_distribution if peak_distribution is not None
        else (lambda x: jnp.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)))

    bin_freqs = jnp.arange(nbins, dtype=jnp.float32) * (sample_rate / nbins)
    harmonic = jnp.round(bin_freqs / fundamental).astype(jnp.int32)
    num_harmonics = int(math.ceil(sample_rate / fundamental)) + 2
    h_idx = jnp.arange(1, num_harmonics + 1, dtype=jnp.float32)
    spread_s = jnp.asarray(spread_fn(h_idx), jnp.float32)
    scale_s = jnp.asarray(scale_fn(h_idx), jnp.float32)

    h_clamped = jnp.clip(harmonic, 1, num_harmonics) - 1
    sd = spread_s[h_clamped]
    sc = scale_s[h_clamped]
    mean = harmonic.astype(jnp.float32) * fundamental
    x = bin_freqs
    r = jnp.where(sd > 1e-3,
                  jnp.asarray(dist_fn((x - mean) / jnp.maximum(sd, 1e-9)),
                              jnp.float32) / jnp.maximum(sd, 1e-9),
                  x) * sc
    r = jnp.where(harmonic == 0, 0.0, r)
    key = jax.random.PRNGKey(seed)
    theta = jax.random.uniform(key, (nbins,), jnp.float32, 0.0,
                               2.0 * math.pi)
    # complex built from real components (large 1-D complex arithmetic is
    # unimplemented on this backend); FFTW's unnormalized c2r vs jnp's
    # 1/n normalization
    spectrum = jax.lax.complex(r * jnp.cos(theta), r * jnp.sin(theta))
    table = jnp.fft.irfft(spectrum, n=wavelength) * wavelength

    out_frames = int(length * sample_rate)
    freq_fn = as_function(freq)
    gran = max(1, int(granularity * sample_rate))
    nblocks = -(-out_frames // gran)
    tgrid = np.arange(nblocks, dtype=np.float64) * gran / sample_rate
    if freq_fn.is_constant:
        f_blocks = np.full(nblocks, freq_fn.constant_value, np.float64)
    else:
        f_blocks = np.asarray(
            freq_fn(jnp.asarray(tgrid, jnp.float32)), np.float64).reshape(-1)
    rate = f_blocks / fundamental  # table frames per output frame
    starts = np.concatenate([[0.0], np.cumsum(rate * gran)])[:-1]
    local = np.arange(gran, dtype=np.float64)
    pos = (starts[:, None] + local[None, :] * rate[:, None]).reshape(-1)
    pos = pos[:out_frames]

    rows = []
    for channel in range(num_channels):
        jump = (channel / num_channels) * wavelength
        p = jnp.mod(jnp.asarray(pos + jump, jnp.float32), wavelength)
        base = jnp.floor(p).astype(jnp.int32)
        frac = p - base
        lo = table[base]
        hi = table[jnp.mod(base + 1, wavelength)]
        rows.append(lo * (1 - frac) + hi * frac)
    audio = Audio(data=jnp.stack(rows), sample_rate=sample_rate)
    return audio.set_volume(1.0)


def synthesize_impulse(base_freq: float, num_harmonics: int = 2 ** 14,
                       chroma: float = 1.0,
                       sample_rate: float = 48000.0):
    """Harmonic cosine-sum impulse (reference AudioSynthesis.cpp:270-303)."""
    from flan_tpu.audio.audio import Audio
    num_frames = int(sample_rate / base_freq)
    if num_frames % 2 == 0:
        num_frames += 1
    half = (num_frames - 1) // 2
    max_h = min(int(num_harmonics), int(sample_rate / 2 / base_freq) + 1)
    max_h = max(max_h, 1)
    if chroma == 1.0:
        norm = 1.0 / num_harmonics if num_harmonics < 2 ** 14 else 1.0 / max_h
        powers = jnp.full((max_h,), norm, jnp.float32)
    else:
        norm = (1.0 - chroma) / (chroma - chroma ** (num_harmonics + 1)) \
            if num_harmonics < 60 else (1.0 - chroma) / chroma
        powers = norm * jnp.power(chroma, jnp.arange(1, max_h + 1,
                                                     dtype=jnp.float32))
    t = jnp.arange(num_frames - half, dtype=jnp.float32) / sample_rate
    h = jnp.arange(1, max_h + 1, dtype=jnp.float32)
    waves = jnp.cos(2.0 * math.pi * base_freq * h[:, None] * t[None, :])
    right = jnp.sum(powers[:, None] * waves, axis=0)
    left = right[1:half + 1][::-1]
    data = jnp.concatenate([left, right])[None, :]
    return Audio(data=data.astype(jnp.float32), sample_rate=sample_rate)


# ===========================================================================
# Granular engine (reference AudioSynthesis.cpp:305-640)
# ===========================================================================
def integrate_event_rate(length: float, events_per_second, scatter,
                         sample_rate: float, *, seed: int = 0
                         ) -> np.ndarray:
    """Density -> event times: integrate the rate, event at each integer
    crossing, then normal-scatter (reference AudioSynthesis.cpp:310-374).
    Host-side numpy; randomness is an explicit seed."""
    n = int(length * sample_rate)
    if n <= 0:
        return np.zeros((0,))
    eps_f = as_function(events_per_second)
    sc_f = as_function(scatter)

    if eps_f.is_constant and sc_f.is_constant:
        # analytic integer crossings of acc[k] = 1 + c*(k+1): O(events)
        # instead of an O(n) cumsum/floor/diff sweep over every sample
        # on the host. Ties differ from the cumsum form only
        # at exact float crossings (measure zero).
        c = max(float(eps_f.constant_value), 0.0) / sample_rate
        if c <= 0.0:
            events = np.array([0], np.int64)
        else:
            m_max = int(np.floor(1.0 + c * n))
            m = np.arange(2, m_max + 1, dtype=np.float64)
            ks = np.ceil((m - 1.0) / c - 1.0).astype(np.int64)
            ks = ks[(ks >= 0) & (ks < n)]
            events = np.unique(np.concatenate([[0], ks]))
        eps = np.broadcast_to(
            np.float64(max(float(eps_f.constant_value), 0.0)), (n,))
        sc = np.broadcast_to(
            np.float64(max(float(sc_f.constant_value), 0.0)), (n,))
    else:
        eps = np.maximum(_sample_fn(events_per_second, n,
                                    1.0 / sample_rate), 0.0)
        sc = np.maximum(_sample_fn(scatter, n, 1.0 / sample_rate), 0.0)

        # accumulator starts at 1, so frame 0 always fires
        # (reference AudioSynthesis.cpp:328-338)
        acc = 1.0 + np.cumsum(eps / sample_rate)
        crossings = np.floor(acc)
        events = np.nonzero(
            np.diff(np.concatenate([[0.0], crossings])) >= 1.0)[0]

    rng = np.random.default_rng(seed)
    if len(events):
        sc_e = sc[events]
        eps_e = eps[events]
        do = (sc_e > 0) & (eps_e > 0)
        std_frames = np.where(do, sc_e / np.maximum(eps_e, 1e-12)
                              * sample_rate, 0.0)
        scattered = np.where(
            do, rng.normal(events.astype(np.float64), std_frames), events)
        keep = (scattered >= 0) & (scattered < n)
        events = np.sort(scattered[keep])
    return events / sample_rate


def synthesize_grains(length: float, grains_per_second, time_scatter,
                      grain_source: Callable, sample_rate: float = 48000.0,
                      *, seed: int = 0):
    """(reference AudioSynthesis.cpp:376-398)"""
    from flan_tpu.audio.audio import Audio
    if length <= 0:
        return Audio.create_null()
    times = integrate_event_rate(length, grains_per_second, time_scatter,
                                 sample_rate, seed=seed)
    grains = [grain_source(float(t)) for t in times]
    grains = [g for g in grains if not g.is_null()]
    if not grains:
        return Audio.create_null()
    return Audio.mix(grains, start_times=list(times[:len(grains)]))


@functools.partial(jax.jit, static_argnames=("out_frames",))
def _impulse_train_conv(frames, gains, grain, *, out_frames: int):
    """Impulse train built ON DEVICE from the tiny event list, then one
    overlap-save FFT convolution (ops/fft_conv.py). Building the train on
    the host would ship a multi-MB array to the device every call; the
    event list is a few KB."""
    from flan_tpu.ops.fft_conv import fft_convolve_full
    train = jnp.zeros((out_frames,), jnp.float32).at[frames].add(gains)
    train_mat = jnp.broadcast_to(train[None],
                                 (grain.shape[0], out_frames))
    return fft_convolve_full(train_mat, grain)[:, :out_frames]


def _mix_repeated(audio, times: np.ndarray, gains=None):
    """Sum copies of one clip at event times: one FFT convolution with an
    impulse train instead of len(times) scatter-adds (the reference's
    synthesize_grains_repeat mixes copy-by-copy,
    AudioSynthesis.cpp:401-421)."""
    from flan_tpu.audio.audio import Audio
    sr = audio.sample_rate
    frames = np.asarray(np.round(np.asarray(times) * sr), np.int64)
    out_frames = int(frames.max()) + audio.num_frames
    g = (np.ones(len(frames), np.float32) if gains is None
         else np.asarray(gains, np.float32))
    out = _impulse_train_conv(jnp.asarray(frames, jnp.int32),
                              jnp.asarray(g), audio.data,
                              out_frames=out_frames)
    return Audio(data=out.astype(jnp.float32), sample_rate=sr)


def _align_grains_to_blocks(grains: jnp.ndarray, r_off: jnp.ndarray,
                            g_n: int, block: int):
    """Shift each grain right by its sub-block remainder r (< block) so
    every grain starts on a block boundary: [G, C, g_n] -> [G, C, L] with
    L = ceil((g_n + block - 1)/block) * block. A small gather."""
    g_c = grains.shape[1]
    nblk_g = -(-(g_n + block - 1) // block)
    L = nblk_g * block
    lane = jnp.arange(L, dtype=jnp.int32)
    idx = lane[None, :] - r_off[:, None]                # [G, L]
    ok = (idx >= 0) & (idx < g_n)
    aligned = jnp.where(
        ok[:, None, :],
        jnp.take_along_axis(grains, jnp.clip(idx, 0, g_n - 1)[:, None, :]
                            .repeat(g_c, axis=1), axis=-1),
        0.0)
    return aligned, nblk_g


def _scatter_mix_blocks(grains: jnp.ndarray, starts: np.ndarray,
                        out_n: int, block: int = 128) -> jnp.ndarray:
    """Mix grains [G, C, g_n] at sample offsets `starts` into [C, out_n]:
    block-align each grain, then land the whole set with ONE row-block
    scatter-add of 128-sample rows."""
    g, g_c, g_n = grains.shape
    q = jnp.asarray(starts // block, jnp.int32)
    r = jnp.asarray(starts % block, jnp.int32)
    aligned, nblk_g = _align_grains_to_blocks(grains, r, g_n, block)
    rows = aligned.reshape(g, g_c, nblk_g, block) \
        .transpose(0, 2, 1, 3).reshape(g * nblk_g, g_c, block)
    ids = (q[:, None] + jnp.arange(nblk_g)[None, :]).reshape(-1)
    nblk_out = -(-(out_n + g_n) // block) + 1
    acc = jnp.zeros((nblk_out, g_c, block), jnp.float32).at[ids].add(rows)
    return acc.transpose(1, 0, 2).reshape(g_c, nblk_out * block)[:, :out_n]


def _texture_mod_batched(self, times: np.ndarray, mod, batch: int = 64,
                         block: int = 128):
    """Dense independent-grain path: grains render
    in vmapped chunks of `batch` under one lax.scan, then mix as ONE
    block-aligned segment scatter-add per chunk instead of a per-grain
    dynamic-update chain. Each grain's arbitrary start splits into
    (block index q, remainder r); a small per-grain gather shifts the
    grain right by r so every grain lands on block boundaries, and the
    whole chunk lands with a single row-block scatter of 128-sample rows.
    Returns None when the mod is not
    jax-traceable (host control flow on t or on the buffer) - the caller
    falls back to the sequential loop."""
    import jax
    from flan_tpu.audio.audio import Audio
    sr = self.sample_rate

    def mod_data(t):
        return mod(self, t).data

    try:
        shape = jax.eval_shape(mod_data, jax.ShapeDtypeStruct((), jnp.float32))
    except Exception:
        return None
    g_c, g_n = shape.shape

    starts = np.round(np.asarray(times) * sr).astype(np.int64)
    out_n = int(starts.max()) + g_n
    g = len(times)
    nchunks = -(-g // batch)
    gpad = nchunks * batch
    t_pad = np.zeros(gpad, np.float32)
    t_pad[:g] = np.asarray(times, np.float32)
    live = np.zeros(gpad, np.float32)
    live[:g] = 1.0
    q_pad = np.zeros(gpad, np.int32)
    r_pad = np.zeros(gpad, np.int32)
    q_pad[:g] = starts // block
    r_pad[:g] = starts % block

    # shifted grain occupies ceil((g_n + block - 1) / block) blocks
    nblk_g = -(-(g_n + block - 1) // block)
    nblk_out = -(-(out_n + g_n) // block) + 1

    ts = jnp.asarray(t_pad).reshape(nchunks, batch)
    lv = jnp.asarray(live).reshape(nchunks, batch)
    qs = jnp.asarray(q_pad).reshape(nchunks, batch)
    rs = jnp.asarray(r_pad).reshape(nchunks, batch)

    def step(acc, inp):
        t_b, l_b, q_b, r_b = inp
        grains = jax.vmap(mod_data)(t_b) * l_b[:, None, None]
        aligned, _ = _align_grains_to_blocks(grains, r_b, g_n, block)
        rows = aligned.reshape(batch, g_c, nblk_g, block) \
            .transpose(0, 2, 1, 3).reshape(batch * nblk_g, g_c, block)
        ids = (q_b[:, None] + jnp.arange(nblk_g)[None, :]).reshape(-1)
        return acc.at[ids].add(rows), None

    acc0 = jnp.zeros((nblk_out, g_c, block), jnp.float32)
    acc, _ = jax.lax.scan(step, acc0, (ts, lv, qs, rs))
    out = acc.transpose(1, 0, 2).reshape(g_c, nblk_out * block)
    return Audio(data=out[:, :out_n], sample_rate=sr)


def texture(self, length: float, grains_per_second, time_scatter,
            mod=None, mod_feedback: bool = False, *, seed: int = 0):
    """Granular texture from a single source
    (reference AudioSynthesis.cpp:423-473). Independent grains (no
    feedback) run batched on device when the mod is traceable."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    times = integrate_event_rate(length, grains_per_second, time_scatter,
                                 self.sample_rate, seed=seed)
    if len(times) == 0:
        return Audio.create_null()
    if mod is None:
        return _mix_repeated(self, times)
    if not mod_feedback:
        batched = _texture_mod_batched(self, times, mod)
        if batched is not None:
            return batched
    grains = []
    current = self
    for i, t in enumerate(times):
        source = current if (mod_feedback and i > 0) else self
        g = mod(source, float(t))
        grains.append(g)
        current = g
    return Audio.mix(grains, start_times=list(times))


def texture_effect(self, effects_per_second, time_scatter, effect_length,
                   mod, fade_time: float = 16.0 / 48000.0,
                   interp=None, *, seed: int = 0):
    """Apply an effect to crossfaded sections
    (reference AudioSynthesis.cpp:475-537)."""
    from flan_tpu.audio.audio import Audio
    from flan_tpu.func import interpolators
    if self.is_null() or mod is None:
        return Audio.create_null()
    if interp is None:
        interp = interpolators.linear
    fade_frames = max(0, self.time_to_frame(fade_time))
    times = integrate_event_rate(self.length, effects_per_second,
                                 time_scatter, self.sample_rate, seed=seed)
    eff_fn = as_function(effect_length)

    out = self.data
    for t in times:
        event_frame = self.time_to_frame(float(t))
        ln = float(np.asarray(eff_fn(jnp.float32(t))).reshape(())) \
            if not eff_fn.is_constant else eff_fn.constant_value
        ln = max(ln, 0.0)
        in_frames = self.time_to_frame(ln)
        piece = self._with(data=out).modify_boundaries_frames(
            event_frame, event_frame + in_frames - self.num_frames)
        piece = mod(piece, float(t))
        out_frames_c = piece.num_frames
        fade_c = min(int(self.time_to_frame(piece.length / 2)), fade_frames)
        piece = piece.fade_frames(fade_c, fade_c, interp)

        n = out.shape[-1]
        ramp = interp(1.0 - jnp.arange(max(fade_c, 1),
                                       dtype=jnp.float32) / max(fade_c, 1))
        if fade_c > 0:
            lo = min(event_frame, n)
            hi = min(event_frame + fade_c, n)
            if hi > lo:
                out = out.at[:, lo:hi].mul(ramp[: hi - lo][None])
            lo2 = min(event_frame + out_frames_c - fade_c + 1, n)
            hi2 = min(event_frame + out_frames_c + 1, n)
            if hi2 > lo2:
                out = out.at[:, lo2:hi2].mul(
                    ramp[::-1][: hi2 - lo2][None])
        # zero the middle
        lo = min(event_frame + fade_c, n)
        hi = min(event_frame + out_frames_c - fade_c + 1, n)
        if hi > lo:
            out = out.at[:, lo:hi].set(0.0)
        # add the piece
        lo = max(event_frame, 0)
        hi = min(event_frame + out_frames_c, n)
        if hi > lo:
            out = out.at[:, lo:hi].add(
                piece.data[:out.shape[0], : hi - lo])
    return self._with(data=out)


def synthesize_pulsars(length: float, pulse_frequency, waveform,
                       waveform_frequency, pulsaret_envelope,
                       sample_rate: float = 48000.0, oversample: int = 4):
    """Pulsar synthesis (Roads): a train of pulsarets — one cycle of
    `waveform` played at `waveform_frequency`, shaped by
    `pulsaret_envelope` over the cycle — emitted at `pulse_frequency`.

    Activated from the reference's commented declaration
    (Audio.h:1139-1145; no implementation upstream). Vectorized design:
    the pulse phase is one mod-1 scan of the sampled pulse rate; the
    pulsaret-local phase is frac(pulse_phase) * wf / pf, the waveform
    and envelope evaluate on it vectorized, and samples where the local
    phase has passed one full cycle are masked to silence (the classic
    pulsar duty-cycle mask; wf < pf leaves no gap, wf > pf overlaps are
    truncated as in single-voice pulsar trains). Rendered `oversample`x
    then polyphase-downsampled like synthesize_waveform."""
    from flan_tpu.audio.audio import Audio
    if length <= 0 or sample_rate <= 0 or oversample < 1:
        return Audio.create_null()
    out_frames = int(length * sample_rate)
    in_rate = sample_rate * oversample
    n_in = out_frames * oversample

    # control rates are built ON DEVICE from their generators like
    # synthesize_waveform (CLAUDE.md transfer rules)
    pf = jnp.maximum(
        as_function(pulse_frequency).sample_device(n_in, 1.0 / in_rate),
        1e-6)
    wf = as_function(waveform_frequency).sample_device(n_in, 1.0 / in_rate)
    inc = jnp.mod(pf / in_rate, 1.0)
    cycles = jax.lax.associative_scan(lambda a, b: jnp.mod(a + b, 1.0), inc)
    phi = jnp.concatenate([jnp.zeros((1,)), cycles[:-1]])

    local = phi * (wf / pf)            # pulsaret waveform cycles elapsed
    live = local < 1.0
    wave_fn = as_function(waveform)
    env_fn = as_function(pulsaret_envelope)
    x = jnp.asarray(wave_fn(local), jnp.float32) \
        * jnp.asarray(env_fn(local), jnp.float32)
    samples = jnp.where(live, x, 0.0)[None, :]
    return Audio(data=samples, sample_rate=in_rate).resample(sample_rate)


def synthesize_trainlets(length: float, grains_per_second, time_scatter,
                         position, trainlet_gain_envelope, impulse_freq,
                         trainlet_length, num_harmonics=2 ** 14, chroma=1.0,
                         impulse_harmonic_frequency=32.0,
                         sample_rate: float = 48000.0, *, seed: int = 0):
    """Trainlet synthesis per "Microsound"
    (reference AudioSynthesis.cpp:543-570)."""
    from flan_tpu.audio.audio import Audio
    pos_fn = position if callable(position) else (lambda t: position)
    env_fn = as_function(trainlet_gain_envelope)
    freq_fn = as_function(impulse_freq)
    tl_fn = as_function(trainlet_length)
    nh_fn = as_function(num_harmonics)
    ch_fn = as_function(chroma)
    ihf_fn = as_function(impulse_harmonic_frequency)

    def scalar(fn, t):
        return float(np.asarray(fn(jnp.float32(t))).reshape(())) \
            if not fn.is_constant else fn.constant_value

    def grain_source(t):
        impulse = synthesize_impulse(
            scalar(ihf_fn, t), int(scalar(nh_fn, t)), scalar(ch_fn, t),
            sample_rate)
        tl = scalar(tl_fn, t)
        times = integrate_event_rate(tl, freq_fn, 0.0, sample_rate,
                                     seed=seed + int(t * 1000) + 1)
        if len(times) == 0:
            return Audio.create_null()
        gains = [scalar(env_fn, float(tt)) for tt in times]
        # identical copies at offsets = one impulse-train convolution
        # (device-built train, _mix_repeated) instead of per-copy mix
        train = _mix_repeated(impulse, np.asarray(times),
                              gains=np.asarray(gains, np.float32))
        pos = pos_fn(t)
        return train.stereo_spatialize(pos) if hasattr(
            train, "stereo_spatialize") else train.convert_to_stereo()

    return synthesize_grains(length, grains_per_second, time_scatter,
                             grain_source, sample_rate, seed=seed)


def _granulate_batched(self, times: np.ndarray, sels: np.ndarray,
                       gls: np.ndarray, fts: np.ndarray, envelope=None):
    """Dense granulate: all grains
    gather from the source in ONE static-index device op (host-known
    starts compile to lane permutations, CLAUDE.md), fade/window
    envelopes broadcast from per-grain scalars, and the set lands with
    the block-aligned scatter mixer - 3 device programs total where the
    sequential path paid per-event cut + eager mix dispatches.

    Replicates cut_frames clamp/null semantics, the sqrt fades with
    proportional shrink, and synthesize_grains' null-drop time pairing
    (surviving grain i plays at times[i])."""
    from flan_tpu.audio.audio import Audio
    sr = self.sample_rate
    n = self.num_frames
    t2f = lambda v: np.asarray(np.round(np.asarray(v, np.float64) * sr),  # noqa: E731
                               np.int64)
    s0 = np.clip(t2f(sels), 0, n - 1)
    e0 = np.clip(t2f(sels + gls), 0, n - 1)
    live = e0 > s0                       # cut_frames -> null otherwise
    s0, e0 = s0[live], e0[live]
    ft_g = np.broadcast_to(t2f(fts), live.shape)[live]
    g = int(live.sum())
    if g == 0:
        return Audio.create_null()
    lens = e0 - s0
    # synthesize_grains drops nulls THEN pairs with the first g times
    starts_out = t2f(np.asarray(times)[:g])

    # sqrt fades with the proportional shrink of fade_frames
    sf = np.clip(ft_g, 0, lens)
    ef = np.clip(ft_g, 0, lens)
    over = sf + ef > lens
    scale = np.where(over, lens / np.maximum(sf + ef, 1), 1.0)
    sf = np.where(over, (sf * scale).astype(np.int64), sf)
    ef = np.where(over, lens - sf, ef)

    # the [G, L] gather-index and envelope matrices are built ON DEVICE
    # from the [G]-sized per-grain scalars instead of shipping them from
    # the host (~23 MB at 600 grains x 0.1 s)
    L = int(lens.max())
    out_n = int((starts_out + lens).max())
    plan = None
    if _RENDER_MODE == "planned":
        plan = _mix_plan(starts_out // 128, L, out_n)
    if plan is not None:
        # the planned render folds alignment into the gather and needs
        # only 5 control rows (no starts_out//128: the plan encodes it)
        meta = np.stack([s0, lens, sf, ef,
                         starts_out % 128]).astype(np.int32)
        data = _granulate_render_planned(
            self.data, jnp.asarray(meta), jnp.asarray(plan),
            L=L, out_n=out_n, envelope=envelope)
    else:
        meta = np.stack([s0, lens, sf, ef, starts_out // 128,
                         starts_out % 128]).astype(np.int32)
        data = _granulate_render(
            self.data, jnp.asarray(meta),
            L=L, out_n=out_n, envelope=envelope)
    return Audio(data=data, sample_rate=sr)


# Render strategy for the dense granulate/psola path (tools/ab_granulate.py
# A/Bs them; on the card the choice is an open question): "planned"
# (default) folds the 128-block
# alignment into the extraction gather and mixes with K host-planned
# accumulating row gathers (every per-grain scalar is host-known numpy,
# so the whole overlap structure is a compile-time plan — the CLAUDE.md
# pv_modify precedent); "legacy" is the round-3 align + scatter-add form.
_RENDER_MODE = "planned"

# Overlap bound above which the planned mixer's K accumulating passes
# stop paying for themselves and the scatter form takes over.
_PLAN_MAX_K = 32

# Total-plan-size cap (int32 elements): the [nblk_out, K] plan ships
# host->device every call — a minutes-long dense output with K near 32
# would ship megabytes per call. 1.5M int32 = 6 MB; beyond it the
# scatter render (device-built indices) takes over.
_PLAN_MAX_ELEMS = 1_500_000


def _mix_plan(q: np.ndarray, g_n: int, out_n: int):
    """Host-side mix plan for _granulate_render_planned: rows[r] is the
    128-lane block row g*nblk_g + b of grain g; plan[o, k] lists the ≤K
    rows landing on output block o (sentinel R = the appended zero row).
    K is bucketed up to the next power of two (sentinel-padded columns)
    so fluctuating overlap across calls reuses one compiled shape instead
    of retracing. Returns None when the
    max overlap exceeds _PLAN_MAX_K or the plan itself would exceed
    _PLAN_MAX_ELEMS (fall back to the scatter mixer)."""
    block = 128
    nblk_g = -(-(g_n + block - 1) // block)
    ids = (q.astype(np.int64)[:, None]
           + np.arange(nblk_g)[None, :]).reshape(-1)
    nblk_out = -(-(out_n + g_n) // block) + 1
    r_total = len(ids)
    counts = np.bincount(ids, minlength=nblk_out)
    k = int(counts.max()) if r_total else 1
    if k > _PLAN_MAX_K:
        return None
    k_pad = 1 << max(k - 1, 0).bit_length()   # next power of two >= k
    if nblk_out * k_pad > _PLAN_MAX_ELEMS:
        return None
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(r_total) - offs[ids_s]
    plan = np.full((nblk_out, k_pad), r_total, np.int32)
    plan[ids_s, rank] = order
    return plan


@functools.partial(jax.jit, static_argnames=("L", "out_n", "envelope"))
def _granulate_render_planned(x, meta, plan, *, L: int, out_n: int,
                              envelope):
    """Planned variant of _granulate_render (same semantics, one compiled
    program): because every per-grain scalar is host numpy, (1) the
    128-block alignment folds into the extraction gather itself
    (idx = s0 - r_off + lane over the padded grain width — no
    _align_grains_to_blocks shift pass), (2) the channel axis stays
    outermost end-to-end (no [G, C, L] transposes), and (3) the
    data-dependent scatter-add mixer becomes K accumulating row gathers
    driven by the host-built plan (_mix_plan). Reference semantics
    unchanged: AudioSynthesis.cpp:572-609 cut/fade/mix. meta carries the
    five rows this path reads (s0, lens, sf, ef, r_off = starts % 128);
    the legacy render's q row is not packed here."""
    s0, lens, sf, ef, r_off = (meta[0], meta[1], meta[2], meta[3],
                               meta[4])
    n = x.shape[-1]
    g_c = x.shape[0]
    block = 128
    nblk_g = -(-(L + block - 1) // block)
    la = nblk_g * block
    lane = jnp.arange(la, dtype=jnp.int32)[None, :] - r_off[:, None]
    mask = ((lane >= 0) & (lane < lens[:, None])).astype(jnp.float32)
    lane_f = lane.astype(jnp.float32)
    lens_f = lens[:, None].astype(jnp.float32)
    sf_f = jnp.maximum(sf[:, None], 1).astype(jnp.float32)
    ef_f = jnp.maximum(ef[:, None], 1).astype(jnp.float32)
    env = jnp.ones(lane.shape, jnp.float32)
    env = jnp.where(lane < sf[:, None],
                    jnp.sqrt(jnp.maximum(lane_f, 0.0) / sf_f), env)
    env = jnp.where((lane >= (lens - ef)[:, None]) & (lane < lens[:, None]),
                    jnp.minimum(env, jnp.sqrt(jnp.maximum(
                        lens_f - 1.0 - lane_f, 0.0) / ef_f)), env)
    if envelope is not None:
        env = env * jnp.asarray(
            envelope(jnp.maximum(lane_f, 0.0)
                     / jnp.maximum(lens_f, 1.0)), jnp.float32)
    env = env * mask

    idx = jnp.clip(s0[:, None] + lane, 0, n - 1)          # [G, La]
    grains = jnp.take(x, idx.reshape(-1), axis=1).reshape(
        g_c, idx.shape[0], la) * env[None]                 # [C, G, La]
    rows = grains.reshape(g_c, idx.shape[0] * nblk_g, block)
    rows = jnp.concatenate(
        [rows, jnp.zeros((g_c, 1, block), jnp.float32)], axis=1)
    acc = jnp.zeros((g_c, plan.shape[0], block), jnp.float32)
    for k in range(plan.shape[1]):
        acc = acc + jnp.take(rows, plan[:, k], axis=1)
    return acc.reshape(g_c, plan.shape[0] * block)[:, :out_n]


@functools.partial(jax.jit, static_argnames=("L", "out_n", "envelope",
                                             "gather_mode", "mix_mode"))
def _granulate_render(x, meta, perm=None, *,
                      L: int, out_n: int, envelope,
                      gather_mode: str = "elem", mix_mode: str = "scatter"):
    """One compiled program: grain gather + fades/window + block mix.

    meta packs the six [G] int32 per-grain control rows (s0, lens, sf,
    ef, q, r_off) into ONE array: every jit argument is its own
    host->device transfer."""
    s0, lens, sf, ef, q, r_off = (meta[0], meta[1], meta[2], meta[3],
                                  meta[4], meta[5])
    n = x.shape[-1]
    lane = jnp.arange(L, dtype=jnp.int32)[None, :]
    mask = (lane < lens[:, None]).astype(jnp.float32)
    lane_f = lane.astype(jnp.float32)
    lens_f = lens[:, None].astype(jnp.float32)
    sf_f = jnp.maximum(sf[:, None], 1).astype(jnp.float32)
    ef_f = jnp.maximum(ef[:, None], 1).astype(jnp.float32)
    env = jnp.ones((s0.shape[0], L), jnp.float32)
    env = jnp.where(lane < sf[:, None], jnp.sqrt(lane_f / sf_f), env)
    env = jnp.where((lane >= (lens - ef)[:, None]) & (lane < lens[:, None]),
                    jnp.minimum(env, jnp.sqrt(jnp.maximum(
                        lens_f - 1.0 - lane_f, 0.0) / ef_f)), env)
    if envelope is not None:
        # modify_volume(g) samples g at frame/sr; hann(tt/ln) = hann(l/len)
        env = env * jnp.asarray(
            envelope(lane_f / jnp.maximum(lens_f, 1.0)), jnp.float32)
    env = env * mask

    # Three extraction formulations (tools/ab_granulate.py A/Bs them; on
    # the card the choice is an open question): "elem" (default) — one
    # [G*L] gather; "slicemap" removes the gather entirely (lax.map of
    # contiguous dynamic_slice); "block" — 128-sample block-row gather +
    # shift.
    if gather_mode == "slicemap":
        # no gather at all: grains are CONTIGUOUS reads, so a lax.map of
        # dynamic_slice extracts them as plain windowed memcpys. x pads L so
        # every start is in bounds; lanes past each grain's length read
        # zeros/stale data and are masked by env.
        xg = jnp.pad(x, [(0, 0), (0, L)])

        def extract(s):
            return jax.lax.dynamic_slice(
                xg, (0, s), (x.shape[0], L))

        grains = jax.lax.map(extract, s0)                 # [G, C, L]
        grains = grains * env[:, None, :]
    elif gather_mode == "block":
        block = 128
        G = s0.shape[0]
        qs = s0 // block
        rs = s0 % block
        nsrc = L // block + 2
        nb = (n - 1) // block + nsrc + 1
        xb = jnp.pad(x, [(0, 0), (0, nb * block - n)]).reshape(
            x.shape[0], nb, block)
        bids = qs[:, None] + jnp.arange(nsrc, dtype=jnp.int32)[None, :]
        src = jnp.take(xb, bids.reshape(-1), axis=1).reshape(
            x.shape[0], G, nsrc * block).transpose(1, 0, 2)   # [G, C, S]
        lidx = (rs[:, None] + lane)[:, None, :]               # [G, 1, L]
        grains = jnp.take_along_axis(
            src, jnp.broadcast_to(lidx, (G, src.shape[1], L)), axis=-1)
        grains = grains * env[:, None, :]
    else:
        # the default: one [G*L] per-element gather
        idx = jnp.minimum(s0[:, None] + lane, n - 1)          # [G, L]
        grains = jnp.take(x, idx.reshape(-1), axis=1).reshape(
            x.shape[0], idx.shape[0], L)
        grains = grains.transpose(1, 0, 2) * env[:, None, :]

    g, g_c = grains.shape[0], grains.shape[1]
    aligned, nblk_g = _align_grains_to_blocks(grains, r_off, L, 128)
    rows = aligned.reshape(g, g_c, nblk_g, 128) \
        .transpose(0, 2, 1, 3).reshape(g * nblk_g, g_c, 128)
    ids = (q[:, None] + jnp.arange(nblk_g)[None, :]).reshape(-1)
    nblk_out = -(-(out_n + L) // 128) + 1
    if mix_mode == "none":
        # ablation arm (tools/ab_granulate.py): WRONG output, times the
        # render with the data-dependent scatter-add removed
        acc = jnp.zeros((nblk_out, g_c, 128), jnp.float32)
        acc = acc.at[:1].add(rows[:1])
    elif mix_mode == "sorted":
        # A/B arm: sorted rows
        # let the scatter lowering use its sorted-indices path
        perm_d = jnp.argsort(ids) if perm is None else perm
        rows_s = jnp.take(rows, perm_d, axis=0)
        ids_s = jnp.take(ids, perm_d)
        acc = jnp.zeros((nblk_out, g_c, 128), jnp.float32).at[ids_s].add(
            rows_s, indices_are_sorted=True)
    else:
        acc = jnp.zeros((nblk_out, g_c, 128), jnp.float32).at[ids].add(rows)
    return acc.transpose(1, 0, 2).reshape(g_c, nblk_out * 128)[:, :out_n]


def granulate(self, length: float, grains_per_second, time_scatter,
              time_selection, grain_length, fade_time=0.0, mod=None,
              *, seed: int = 0, _envelope=None):
    """Granular synthesis reading grains from the input
    (reference AudioSynthesis.cpp:572-609). With no mod the grains
    extract, fade and mix as three batched device programs; a mod falls
    back to the reference-shaped per-event path."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    sel_fn = as_function(time_selection)
    gl_fn = as_function(grain_length)
    ft_fn = as_function(fade_time)

    if mod is None:
        times = integrate_event_rate(length, grains_per_second,
                                     time_scatter, self.sample_rate,
                                     seed=seed)
        if len(times) == 0:
            return Audio.create_null()
        # evaluate the control functions on NUMPY inputs: each jnp-array
        # eval is an eager device round trip; pure-arithmetic host
        # lambdas never touch the device this way
        tj = np.asarray(times, np.float32)
        sels = np.asarray(sel_fn(tj), np.float64).reshape(-1)
        sels = np.broadcast_to(sels, times.shape)
        gls = np.asarray(gl_fn(tj), np.float64).reshape(-1)
        gls = np.broadcast_to(gls, times.shape)
        fts = np.asarray(ft_fn(tj), np.float64).reshape(-1)
        fts = np.broadcast_to(fts, times.shape)
        return _granulate_batched(self, times, sels, gls, fts,
                                  envelope=_envelope)

    def scalar(fn, t):
        return float(np.asarray(fn(jnp.float32(t))).reshape(())) \
            if not fn.is_constant else fn.constant_value

    def grain_source(t):
        sel = scalar(sel_fn, t)
        gl = scalar(gl_fn, t)
        ft = scalar(ft_fn, t)
        grain = self.cut(sel, sel + gl, ft, ft)
        if grain.is_null():
            return grain
        grain = mod(grain, t)
        if _envelope is not None and not grain.is_null():
            ln = grain.length
            grain = grain.modify_volume(
                lambda tt: _envelope(tt / ln))
        return grain

    return synthesize_grains(length, grains_per_second, time_scatter,
                             grain_source, self.sample_rate, seed=seed)


def psola(self, length: float, time_selection, mod=None, *, seed: int = 0):
    """Pitch-synchronous overlap-add (reference
    AudioSynthesis.cpp:611-638): grain rate tracks the source pitch at the
    selected time, grains are two periods long with hann windows."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    freq = self.get_frequency_envelope()
    sel_fn = as_function(time_selection)

    def sel(t):
        return float(np.asarray(sel_fn(jnp.float32(t))).reshape(())) \
            if not sel_fn.is_constant else sel_fn.constant_value

    def freq_at(t):
        v = float(np.asarray(freq(jnp.float32(sel(t)))).reshape(()))
        return max(v, 1e-3)

    # the hann window over each grain's true length rides the _envelope
    # hook so the no-mod case stays on the batched dense path
    return granulate(
        self, length,
        lambda t: jnp.maximum(jnp.asarray(
            [freq_at(float(x)) for x in np.atleast_1d(np.asarray(t))],
            jnp.float32).reshape(jnp.shape(t)), 1.0),
        0.0,
        lambda t: sel_fn(t),
        lambda t: 2.0 / jnp.maximum(jnp.asarray(
            [freq_at(float(x)) for x in np.atleast_1d(np.asarray(t))],
            jnp.float32).reshape(jnp.shape(t)), 1e-3),
        0.05, mod, seed=seed, _envelope=hann)
