"""Synthesis & granular tests (reference AudioSynthesis.cpp)."""
import numpy as np
import pytest

from flan_tpu import Audio

SR = 8000.0


def dominant_freq(audio, start, count):
    x = np.asarray(audio.data[0, start:start + count])
    spec = np.abs(np.fft.rfft(x))
    return spec.argmax() * audio.sample_rate / count


def test_synthesize_waveform_sine():
    from flan_tpu.func.function import waveforms
    a = Audio.synthesize_waveform(waveforms.sine, 0.5, 440.0, SR,
                                  oversample=4)
    assert a.num_frames == int(0.5 * SR)
    assert dominant_freq(a, 1000, 2000) == pytest.approx(440, abs=5)
    peak = float(np.abs(np.asarray(a.data)).max())
    assert 0.9 < peak < 1.1


def test_synthesize_waveform_sweep():
    from flan_tpu.func.function import waveforms
    a = Audio.synthesize_waveform(waveforms.sine, 1.0,
                                  lambda t: 200.0 + 400.0 * t, SR,
                                  oversample=4)
    f_early = dominant_freq(a, 500, 1024)
    f_late = dominant_freq(a, 6500, 1024)
    assert f_late > f_early + 150


def test_white_noise():
    a = Audio.synthesize_white_noise(0.25, SR, oversample=2, seed=1)
    assert a.num_frames == int(0.25 * SR)
    d = np.asarray(a.data)
    assert np.abs(d.mean()) < 0.05
    assert d.std() > 0.2


def test_pink_noise_spectrum():
    """Pink noise has more low than high energy."""
    a = Audio.synthesize_pink_noise(1.0, SR, seed=2)
    spec = np.abs(np.fft.rfft(np.asarray(a.data[0]))) ** 2
    low = spec[10:100].mean()
    high = spec[2000:4000].mean()
    assert low > high * 3


def test_synthesize_impulse():
    a = Audio.synthesize_impulse(100.0, 10, 1.0, SR)
    d = np.asarray(a.data[0])
    # symmetric around center with the peak there
    assert d.argmax() == len(d) // 2
    np.testing.assert_allclose(d, d[::-1], atol=1e-4)


def test_integrate_event_rate():
    from flan_tpu.audio.synthesis import integrate_event_rate
    times = integrate_event_rate(1.0, 10.0, 0.0, SR)
    assert len(times) == pytest.approx(10, abs=1)
    # evenly spaced at 0.1s
    assert np.allclose(np.diff(times), 0.1, atol=0.01)
    scattered = integrate_event_rate(1.0, 10.0, 1.0, SR, seed=3)
    assert len(scattered) <= 11
    assert not np.allclose(np.diff(scattered), 0.1, atol=0.001)


def test_texture_repeats():
    t = np.arange(800, dtype=np.float32) / SR
    grain = Audio.create_from_array(
        (0.1 * np.sin(2 * np.pi * 400 * t))[None], SR)
    tex = grain.texture(0.5, 20.0, 0.0)
    assert not tex.is_null()
    assert tex.num_frames >= int(0.4 * SR)


def test_texture_mod_applies():
    grain = Audio.create_from_array(np.ones((1, 100), np.float32), SR)
    tex = grain.texture(0.2, 10.0, 0.0,
                        mod=lambda a, t: a.modify_volume(0.0))
    assert float(np.abs(np.asarray(tex.data)).max()) == 0.0


def test_delay_decays():
    x = np.zeros((1, 400), np.float32)
    x[0, 0:50] = 1.0
    a = Audio.create_from_array(x, SR)
    d = a.delay(0.2, 0.05, decay=0.5)
    arr = np.asarray(d.data[0])
    first = np.abs(arr[0:50]).max()
    second = np.abs(arr[400:450]).max()
    assert first == pytest.approx(1.0, abs=0.05)
    assert 0.1 < second < 0.9  # decayed copies present


def test_granulate():
    t = np.arange(int(SR), dtype=np.float32) / SR
    a = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 300 * t))[None], SR)
    g = a.granulate(0.5, 30.0, 0.0, time_selection=0.2, grain_length=0.05,
                    fade_time=0.01)
    assert not g.is_null()
    assert g.num_frames >= int(0.4 * SR)


def test_texture_mod_batched_matches_sequential():
    """The batched independent-grain path equals grain-by-grain
    mixing."""
    import jax.numpy as jnp
    from flan_tpu.audio import synthesis as S
    sr = 8000.0
    t = np.arange(2000, dtype=np.float32) / sr
    a = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 440 * t))[None].astype(np.float32), sr)
    mod = lambda src, tt: src._with(data=src.data * (0.5 + 0.1 * jnp.sin(tt)))
    fast = a.texture(2.0, 15.0, 0.1, mod=mod, seed=3)
    times = S.integrate_event_rate(2.0, 15.0, 0.1, sr, seed=3)
    slow = Audio.mix([mod(a, float(x)) for x in times],
                     start_times=list(times))
    m = min(fast.num_frames, slow.num_frames)
    np.testing.assert_allclose(np.asarray(fast.data[:, :m]),
                               np.asarray(slow.data[:, :m]), atol=1e-6)


def test_psola_preserves_pitch():
    """PSOLA at unchanged rate reproduces the source pitch: grain rate
    tracks the detected pitch and each grain spans two periods
    (reference AudioSynthesis.cpp:611-638)."""
    t = np.arange(int(SR), dtype=np.float32) / SR
    src = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 200 * t))[None], SR)
    out = src.psola(0.5, 0.5)
    assert not out.is_null()
    assert out.num_frames >= int(0.4 * SR)
    assert np.isfinite(np.asarray(out.data)).all()
    assert dominant_freq(out, 1000, 2048) == pytest.approx(200, abs=20)


def test_psola_mod_applies():
    t = np.arange(int(SR), dtype=np.float32) / SR
    src = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 200 * t))[None], SR)
    out = src.psola(0.3, 0.5, mod=lambda a, tt: a.modify_volume(0.0))
    assert float(np.abs(np.asarray(out.data)).max()) == 0.0


def test_synthesize_trainlets():
    """Trainlets: spatialized trains of harmonic impulses
    (reference AudioSynthesis.cpp:543-570; position is a vec2)."""
    tr = Audio.synthesize_trainlets(
        0.5, 6.0, 0.0, (1.0, 0.0), 1.0, 200.0, 0.05,
        num_harmonics=16, chroma=1.0, impulse_harmonic_frequency=100.0,
        sample_rate=SR, seed=1)
    assert not tr.is_null()
    assert tr.num_channels == 2  # stereo_spatialize output
    assert tr.num_frames >= int(0.4 * SR)
    d = np.asarray(tr.data)
    assert np.isfinite(d).all()
    assert np.sqrt((d ** 2).mean()) > 0.01
    # position (1, 0) is dead ahead: both ears get comparable energy
    el, er = (d[0] ** 2).sum(), (d[1] ** 2).sum()
    assert 0.2 < el / er < 5.0


def test_synthesize_spectrum():
    """Giant-IFFT spectrum playback (reference AudioSynthesis.cpp:151-268).

    Behavioral quirk preserved from the reference: harmonics are painted
    at bins b_h where b_h * sr / nbins = h * fundamental, but playback
    advances freq/fundamental *table frames* per output frame, so
    harmonic h sounds at h * freq * nbins / wavelength ~= h * freq / 2.
    """
    sp = Audio.synthesize_spectrum(0.3, 200.0, fundamental_power=6,
                                   spectrum_size_power=14, num_channels=1,
                                   sample_rate=SR, seed=0)
    assert not sp.is_null()
    assert sp.num_frames == int(0.3 * SR)
    d = np.asarray(sp.data)
    assert np.isfinite(d).all()
    assert float(np.abs(d).max()) == pytest.approx(1.0, abs=0.01)  # set_volume(1)
    wavelength = 2 ** 14
    nbins = wavelength // 2 + 1
    expected = 200.0 * nbins / wavelength  # ~100 Hz, reference quirk
    assert dominant_freq(sp, 200, 2048) == pytest.approx(expected, abs=15)


def test_synthesize_spectrum_invalid_args_null():
    assert Audio.synthesize_spectrum(0.0, 200.0).is_null()
    assert Audio.synthesize_spectrum(
        0.3, 200.0, fundamental_power=20, spectrum_size_power=14).is_null()


def test_texture_mod_untraceable_falls_back():
    sr = 8000.0
    t = np.arange(2000, dtype=np.float32) / sr
    a = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 440 * t))[None].astype(np.float32), sr)
    mod = lambda src, tt: src.cut(0.0, 0.05 + float(tt) * 0.0)
    out = a.texture(1.0, 10.0, 0.0, mod=mod, seed=1)
    assert not out.is_null()


def test_granulate_batched_matches_sequential():
    """granulate with no mod (dense batched path) equals the per-event
    fallback (forced via an identity mod), including cut end clamps,
    fade shrink (fade > grain/2) and dropped null grains."""
    rng = np.random.default_rng(11)
    sr = 8000.0
    a = Audio.create_from_array(
        rng.standard_normal((2, 8000)).astype(np.float32) * 0.3, sr)
    kw = dict(time_selection=lambda t: 0.8 * t,   # runs past the end
              grain_length=0.05, fade_time=0.04,  # forces fade shrink
              seed=5)
    fast = a.granulate(1.2, 25.0, 0.05, **kw)
    slow = a.granulate(1.2, 25.0, 0.05, mod=lambda g, t: g, **kw)
    assert fast.num_frames == slow.num_frames
    np.testing.assert_allclose(np.asarray(fast.data),
                               np.asarray(slow.data), atol=2e-5)


def test_granulate_planned_matches_legacy_render():
    """The round-4 planned render (fused-alignment gather + host-planned
    K-pass gather mixer) equals the legacy align + scatter-add render
    bit-for-bit in structure (same grains, same envelope math; only the
    f32 mix summation order differs)."""
    from flan_tpu.audio import synthesis
    rng = np.random.default_rng(3)
    sr = 8000.0
    a = Audio.create_from_array(
        rng.standard_normal((2, 8000)).astype(np.float32) * 0.3, sr)
    kw = dict(time_selection=lambda t: 0.7 * t, grain_length=0.06,
              fade_time=0.02, seed=9)
    planned = a.granulate(1.0, 30.0, 0.04, **kw)
    assert synthesis._RENDER_MODE == "planned"
    try:
        synthesis._RENDER_MODE = "legacy"
        legacy = a.granulate(1.0, 30.0, 0.04, **kw)
    finally:
        synthesis._RENDER_MODE = "planned"
    assert planned.num_frames == legacy.num_frames
    np.testing.assert_allclose(np.asarray(planned.data),
                               np.asarray(legacy.data), atol=1e-6)


def test_mix_plan_overflow_falls_back():
    """A pathological overlap (> _PLAN_MAX_K grains on one block) returns
    None from _mix_plan and the caller falls back to the scatter render."""
    from flan_tpu.audio import synthesis
    q = np.zeros(synthesis._PLAN_MAX_K + 1, np.int64)  # all on block 0
    assert synthesis._mix_plan(q, 1, 256) is None
    plan = synthesis._mix_plan(np.array([0, 1]), 1, 256)
    assert plan is not None and plan.shape[1] == 1


def test_psola_batched_matches_sequential():
    sr = 8000.0
    t = np.arange(8000, dtype=np.float32) / sr
    a = Audio.create_from_array(
        (0.5 * np.sin(2 * np.pi * 220.0 * t))[None], sr)
    fast = a.psola(0.8, lambda tt: 0.5 * tt, seed=2)
    slow = a.psola(0.8, lambda tt: 0.5 * tt, mod=lambda g, x: g, seed=2)
    assert fast.num_frames == slow.num_frames
    np.testing.assert_allclose(np.asarray(fast.data),
                               np.asarray(slow.data), atol=2e-5)


def test_integrate_event_rate_analytic_matches_cumsum():
    """The constant-rate analytic fast path equals the O(n) cumsum sweep
    up to exact-integer crossing ties (where the cumsum's accumulated
    f64 rounding resolves arbitrarily): event counts within 1 and every
    event within 1 frame."""
    from flan_tpu.audio.synthesis import integrate_event_rate
    for L, e, s, sr in [(2.0, 13.3, 0.0, 8000.0), (1.0, 7.0, 0.0, 8000.0),
                        (0.5, 100.0, 0.0, 44100.0)]:
        fast = integrate_event_rate(L, e, s, sr, seed=0)
        slow = integrate_event_rate(L, lambda t: e + 0.0 * t,
                                    lambda t: s + 0.0 * t, sr, seed=0)
        assert abs(len(fast) - len(slow)) <= 1, (len(fast), len(slow))
        m = min(len(fast), len(slow))
        assert np.abs(np.asarray(fast[:m]) * sr
                      - np.asarray(slow[:m]) * sr).max() <= 1.0 + 1e-6
