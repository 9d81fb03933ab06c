"""Salience / contours / prism tests (reference PVInformation.cpp)."""
import numpy as np
import pytest

from flan_tpu import Audio

SR = 8000.0
WINDOW, HOP, DFT = 512, 64, 512


@pytest.fixture(scope="module")
def melody_pv():
    """Two sequential notes: 220 Hz then 440 Hz."""
    t = np.arange(int(0.4 * SR), dtype=np.float32) / SR
    a = 0.5 * np.sin(2 * np.pi * 220 * t)
    b = 0.5 * np.sin(2 * np.pi * 440 * t)
    sig = np.concatenate([a, b])[None].astype(np.float32)
    return Audio.create_from_array(sig, SR).convert_to_PV(WINDOW, HOP, DFT)


def test_salience_peaks_at_notes(melody_pv):
    sal = melody_pv.get_salience(0, 55.0, 1760.0)
    assert sal.num_frames == melody_pv.num_frames
    assert sal.buffer.max() == pytest.approx(1.0)
    # pitch bin of 220 Hz: 120 * log2(220/55) = 240
    early = sal.buffer[10:30].mean(axis=0)
    assert abs(early.argmax() - 240) <= 12
    late = sal.buffer[-30:-10].mean(axis=0)
    assert abs(late.argmax() - 360) <= 12  # 440 Hz -> bin 360


def test_contours_track_notes(melody_pv):
    contours = melody_pv.get_contours(0, filter_short=10)
    assert len(contours) >= 2
    contours.sort(key=lambda c: c.start_frame)
    freqs = [55.0 * 2 ** (c.pitch_mean / 120.0) for c in contours[:2]]
    assert min(abs(f - 220) for f in freqs) < 15
    assert min(abs(f - 440) for f in freqs) < 25


def test_prism_identity(melody_pv):
    """A prism function returning each harmonic unchanged approximately
    preserves the PV (reference PVInformation.cpp:265-421)."""
    def identity(note, t, harmonic, base_freq, harmonic_mags):
        return harmonic_mags[harmonic - 1], base_freq * harmonic

    pr = melody_pv.prism(identity, use_local_contour_time=False)
    assert not pr.is_null()
    e_in = float(np.square(np.asarray(melody_pv.mag)).sum())
    e_out = float(np.square(np.asarray(pr.mag)).sum())
    assert e_out == pytest.approx(e_in, rel=0.35)


def test_prism_octave_up(melody_pv):
    """Doubling every harmonic frequency shifts energy up an octave."""
    def octave(note, t, harmonic, base_freq, harmonic_mags):
        return harmonic_mags[harmonic - 1], base_freq * harmonic * 2.0

    pr = melody_pv.prism(octave)
    mid = 20
    m = np.asarray(pr.mag[0, mid])
    b440 = int(440.0 / pr.bin_width)
    b220 = int(220.0 / pr.bin_width)
    assert m[b440 - 2:b440 + 3].max() > m[b220 - 2:b220 + 3].max()


def test_prism_batched_matches_scalar_reference(melody_pv):
    """The batched prism rewrite must reproduce the scalar loop
    on non-overlapping contours."""
    from flan_tpu.pv.information import _prism_scalar_reference

    def octave(note, t, harmonic, base_freq, harmonic_mags):
        return harmonic_mags[harmonic - 1], base_freq * harmonic * 2.0

    fast = melody_pv.prism(octave, use_local_contour_time=False)
    slow = _prism_scalar_reference(melody_pv, octave,
                                   use_local_contour_time=False)
    np.testing.assert_allclose(np.asarray(fast.mag), np.asarray(slow.mag),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(fast.freq), np.asarray(slow.freq),
                               atol=1e-2)


def test_prism_tie_semantics_zero_mag_taps(melody_pv):
    """Freq writes happen only on STRICT magnitude improvement (reference
    'if (out < sm)'); zero-magnitude taps with valid frequencies must not
    overwrite freq (round-2 review finding 2)."""
    import jax.numpy as jnp
    from flan_tpu.pv.information import _prism_scalar_reference

    # zero out a band of magnitudes while keeping their frequencies: the
    # scatter ties at 0 exactly where the old >= comparison diverged
    mag = melody_pv.mag.at[:, :, 40:60].set(0.0)
    pv = melody_pv._with(mag=mag)

    def octave(note, t, harmonic, base_freq, harmonic_mags):
        return harmonic_mags[harmonic - 1], base_freq * harmonic * 2.0

    fast = pv.prism(octave, use_local_contour_time=False)
    slow = _prism_scalar_reference(pv, octave, use_local_contour_time=False)
    np.testing.assert_allclose(np.asarray(fast.mag), np.asarray(slow.mag),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(fast.freq), np.asarray(slow.freq),
                               atol=1e-2)


def test_salience_adaptive_k_lossless_on_dense_polyphony():
    """The default (adaptive-K) salience equals
    an uncapped all-bins run on material whose per-frame peak count
    exceeds the old fixed cap of 64."""
    rng = np.random.default_rng(0)
    n = int(SR * 2)
    t = np.arange(n) / SR
    # 90 inharmonic partials across the band + noise floor: every frame
    # carries far more than 64 strict local maxima above the -40 dB gate
    freqs = np.linspace(60.0, 3600.0, 90) * (1 + 0.003 * rng.standard_normal(90))
    sig = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) / 30.0
              for f in freqs)
    sig = (sig + 0.02 * rng.standard_normal(n)).astype(np.float32)[None]
    pv = Audio.create_from_array(sig, SR).convert_to_PV(WINDOW, HOP, DFT)

    import jax.numpy as jnp
    mag = pv.mag[0]
    mid = mag[:, 1:-1]
    is_peak = (mid > mag[:, :-2]) & (mid >= mag[:, 2:])
    gate = jnp.max(mag, axis=-1, keepdims=True) / (10.0 ** (40.0 / 20.0))
    count = int(jnp.max(jnp.sum(
        jnp.pad(is_peak, [(0, 0), (1, 1)]) & (mag > gate), axis=-1)))
    assert count > 64, count  # the scenario actually stresses the old cap

    sal_default = pv.get_salience(0, 55.0, 1760.0)
    sal_full = pv.get_salience(0, 55.0, 1760.0,
                               max_peaks=pv.mag.shape[-1])
    np.testing.assert_allclose(sal_default.buffer, sal_full.buffer,
                               atol=1e-6)
