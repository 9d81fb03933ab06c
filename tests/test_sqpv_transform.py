"""Activated SQPV algorithm layer: sliding constant-Q transform + algos.

The reference ships these written but commented out
(reference: src/flan/Conversions/AudioSQPV.cpp:1-170, SQPV/SQPV.cpp:1-142);
flan_tpu activates them. Oracles are analytic: the pitch plane of a pure
tone must read log2(f0) regardless of the bin grid, and the round trip
must reproduce a spectrally pure tone up to the transform's fixed gain
and the zero-initial-phase convention (same convention as PV round trips).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from flan_tpu import Audio
from flan_tpu.sqpv import SQPV

SR = 8000.0
BW = (200.0, 2000.0)
BPO = 8.0


def _tone(f0=440.0, n=3000, amp=0.5, ch=1):
    t = np.arange(n, dtype=np.float32) / SR
    x = (amp * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    return Audio.create_from_array(np.tile(x, (ch, 1)), SR)


def _fit_tone_snr(y, f0, sr=SR, lo=1000, hi=2500):
    """SNR after fitting amplitude+phase (the inverse accumulates phase
    from zero, so absolute phase is not preserved — as in PV)."""
    s = slice(lo, hi)
    t = np.arange(len(y), dtype=np.float64)[s] / sr
    A = np.stack([np.sin(2 * np.pi * f0 * t), np.cos(2 * np.pi * f0 * t)], 1)
    coef, *_ = np.linalg.lstsq(A, y[s], rcond=None)
    fit = A @ coef
    err = y[s] - fit
    amp = float(np.hypot(*coef))
    snr = 10 * np.log10(np.dot(fit, fit) / max(np.dot(err, err), 1e-20))
    return amp, snr


def test_forward_pitch_plane_reads_true_pitch():
    sq = _tone(440.0).convert_to_SQPV(BW, BPO)
    assert sq.num_frames == 3000
    assert sq.num_bins == SQPV.num_bins_for(BW, BPO)
    m = np.asarray(sq.mag[0])
    pk = int(m[1500].argmax())
    # peak bin is the nearest constant-Q bin to 440
    assert abs(sq.bin_to_frequency(pk) - 440.0) < 440.0 * (2 ** (1 / BPO) - 1)
    # the vocoded pitch refines the bin grid to the true pitch
    pitch = float(np.asarray(sq.pitch[0, 1500, pk]))
    assert abs(pitch - np.log2(440.0)) < 1e-3
    assert bool(np.asarray(sq.positive[0, 1500, pk]))


def test_round_trip_tone_snr():
    a = _tone(440.0)
    sq = a.convert_to_SQPV(BW, BPO)
    y = np.asarray(sq.convert_to_audio().data)[0]
    amp, snr = _fit_tone_snr(y, 440.0)
    assert snr > 40.0, f"round-trip SNR {snr} dB"
    assert amp > 0.01  # non-degenerate reconstruction


def test_round_trip_gain_is_frequency_stable():
    """The transform's fixed round-trip gain must not depend on where the
    tone sits relative to the bin grid (within the hann ripple)."""
    amps = []
    for f0 in (330.0, 440.0, 523.25):
        sq = _tone(f0).convert_to_SQPV(BW, BPO)
        y = np.asarray(sq.convert_to_audio().data)[0]
        amp, snr = _fit_tone_snr(y, f0)
        assert snr > 35.0, (f0, snr)
        amps.append(amp)
    assert max(amps) / min(amps) < 1.5, amps


def test_repitch_shifts_pitch_plane_by_log2_factor():
    sq = _tone(440.0).convert_to_SQPV(BW, BPO)
    up = sq.repitch(2.0)
    d = np.asarray(up.pitch - sq.pitch)
    assert np.allclose(d, 1.0, atol=1e-5)
    # magnitudes untouched
    assert np.array_equal(np.asarray(up.mag), np.asarray(sq.mag))


def test_repitched_audio_moves_octave():
    sq = _tone(440.0, n=4000).convert_to_SQPV(BW, BPO)
    y = np.asarray(sq.repitch(2.0).convert_to_audio().data)[0]
    amp, snr = _fit_tone_snr(y, 880.0, lo=1500, hi=3500)
    assert snr > 25.0, snr


def test_modify_pitch_applies_callable():
    sq = _tone(440.0).convert_to_SQPV(BW, BPO)
    out = sq.modify_pitch(lambda t, p: p + 0.5)
    assert np.allclose(np.asarray(out.pitch - sq.pitch), 0.5, atol=1e-6)


def test_select_identity_preserves_data():
    sq = _tone(440.0, n=2000).convert_to_SQPV(BW, BPO)
    out = sq.select(2000 / SR, lambda t, p: t)
    assert out.num_frames == 2000
    # interior frames: identity selection reproduces the buffer
    a = np.asarray(out.mag[0, 100:1900])
    b = np.asarray(sq.mag[0, 100:1900])
    assert np.allclose(a, b, atol=1e-4 * float(b.max()))


def test_select_out_of_range_zeros():
    sq = _tone(440.0, n=1000).convert_to_SQPV(BW, BPO)
    out = sq.select(0.1, lambda t, p: t + 100.0)  # far out of range
    assert float(np.abs(np.asarray(out.mag)).max()) == 0.0


def test_ms_sqpv_and_lr_audio():
    a = _tone(440.0, ch=2)
    sq = a.convert_to_ms_SQPV(BW, BPO)
    assert sq.num_channels == 2
    # identical L/R -> side channel is silent
    assert float(np.abs(np.asarray(sq.mag[1])).max()) < \
        1e-3 * float(np.abs(np.asarray(sq.mag[0])).max())
    lr = sq.convert_to_lr_audio()
    assert lr.num_channels == 2


def test_graph_smoke(tmp_path):
    sq = _tone(440.0, n=1000).convert_to_SQPV(BW, BPO)
    g = sq.convert_to_graph(width=64, height=32)
    assert g.image.shape == (32, 64, 3)
    sq.save_to_bmp(str(tmp_path / "sq.bmp"), width=64, height=32)
    assert (tmp_path / "sq.bmp").stat().st_size > 0


def test_null_propagation():
    assert SQPV.create_null().repitch(2.0).is_null()
    assert SQPV.create_null().convert_to_audio().is_null()
    assert Audio.create_null().convert_to_SQPV(BW, BPO).is_null()


def test_odd_period_trunc_semantics():
    """Bins with odd N_k exercise the reference's float->int truncation of
    frame +- N_k/2 (AudioSQPV.cpp:100-103); the transform must stay finite
    and consistent at those bins."""
    sq = _tone(440.0, n=1500).convert_to_SQPV(BW, BPO)
    q = sq.q
    periods = np.ceil(q * SR / sq.bin_frequencies()).astype(int)
    assert (periods % 2 == 1).any(), "test needs at least one odd period"
    m = np.asarray(sq.mag)
    assert np.isfinite(m).all()
    assert np.isfinite(np.asarray(sq.pitch)).all()


def _sqpv_forward_f64(x, sr, bpo, bw):
    """Float64 sliding constant-Q transform, sample by sample, written
    from the reference (AudioSQPV.cpp:82-125): each bin's recurrence
    F_j[t] = a_j * (F_j[t-1] + (fiddle * x[t + N/2] - x[t - N/2]) / N)
    with the sample offsets truncated toward zero as the reference's
    float -> int conversion does, then the spectral hann window and
    lag-1 phase vocoding at analysis rate == sample rate."""
    c, n = x.shape
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    nb = int(np.ceil((np.log2(bw[1]) - np.log2(bw[0])) * bpo))
    freqs = 2.0 ** (np.arange(nb) / bpo + np.log2(bw[0]))
    period = np.ceil(q * sr / freqs)
    a = np.exp(1j * 2 * np.pi * (q + np.array([-1.0, 0.0, 1.0]))[:, None]
               / period[None])                            # [3, B]
    fiddle = np.exp(-1j * 2 * np.pi * q)
    xd = x.astype(np.float64)

    def at(idx):  # [B] int -> [C, B], zero outside the signal
        ok = (idx >= 0) & (idx < n)
        return np.where(ok[None], xd[:, np.clip(idx, 0, n - 1)], 0.0)

    w0 = int(period.max() // 2 + 2)
    F = np.zeros((3, c, nb), np.complex128)
    prev = np.zeros((c, nb))
    mag = np.zeros((c, n, nb))
    freq = np.zeros((c, n, nb))
    expected = freqs / sr * 2 * np.pi
    for t in range(-w0, n):
        new = np.trunc(t + period / 2.0).astype(np.int64)
        old = np.trunc(t - period / 2.0).astype(np.int64)
        u = (fiddle * at(new) - at(old)) / period[None]
        F = a[:, None, :] * (F + u[None])
        fw = 0.5 * F[1] - 0.25 * (F[0] + F[2])
        phase = np.angle(fw)
        if t >= 0:
            d = phase - prev - expected
            d -= 2 * np.pi * np.round(d / (2 * np.pi))
            mag[:, t] = np.abs(fw)
            freq[:, t] = freqs + d * sr / (2 * np.pi)
        prev = phase
    return mag, freq


@pytest.mark.parametrize("bpo", [4.0, 8.0])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [700, 1337])
def test_sqpv_scan_matches_float64_reference(bpo, channels, n):
    """The chunked modulated prefix sums (256-frame chunks, carried
    state, host twiddle tables, staged comb with the truncation quirk)
    equal the sample-by-sample float64 recurrence on ragged lengths."""
    from flan_tpu.sqpv.transform import sqpv_forward
    rng = np.random.default_rng(int(bpo) + channels + n)
    x = (0.3 * rng.standard_normal((channels, n))).astype(np.float32)
    mag, pitch, positive = sqpv_forward(jnp.asarray(x), SR, bpo, BW,
                                        chunk=256)
    mag_ref, freq_ref = _sqpv_forward_f64(x, SR, bpo, BW)
    mag = np.asarray(mag)
    assert mag.shape == mag_ref.shape
    scale = mag_ref.max()
    assert np.abs(mag - mag_ref).max() < 1e-4 * scale
    strong = (mag_ref > 1e-2 * scale) & (np.abs(freq_ref) > 1.0)
    freq = np.where(np.asarray(positive), 1.0, -1.0) * np.exp2(
        np.asarray(pitch, np.float64))
    dfreq = np.abs(freq - freq_ref)[strong]
    dfreq = np.minimum(dfreq, np.abs(dfreq - SR))  # a +-pi wrap is SR Hz
    assert dfreq.max() < 1e-3 * SR


@pytest.mark.parametrize("channels,n", [(1, 700), (2, 1337)])
def test_sqpv_inverse_matches_float64_reference(channels, n):
    """Phase accumulation of the pitch-decoded frequencies and the
    twiddle-rotated real sum (AudioSQPV.cpp:128-165) vs float64 numpy."""
    from flan_tpu.sqpv.transform import sqpv_inverse
    bpo = 8.0
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    nb = int(np.ceil((np.log2(BW[1]) - np.log2(BW[0])) * bpo))
    period = np.ceil(q * SR / 2.0 ** (np.arange(nb) / bpo
                                      + np.log2(BW[0])))
    rng = np.random.default_rng(n)
    mag = rng.random((channels, n, nb)).astype(np.float32)
    pitch = rng.uniform(np.log2(30.0), np.log2(3000.0),
                        (channels, n, nb)).astype(np.float32)
    positive = rng.random((channels, n, nb)) > 0.2
    y = np.asarray(sqpv_inverse(jnp.asarray(mag), jnp.asarray(pitch),
                                jnp.asarray(positive), SR, bpo, BW))
    freq = np.where(positive, 1.0, -1.0) * np.exp2(pitch.astype(np.float64))
    cycles = np.mod(np.cumsum(np.mod(freq / SR, 1.0), axis=1), 1.0)
    tw = np.exp(1j * 2 * np.pi * q / period)
    ref = np.sum(mag * (np.cos(2 * np.pi * cycles) * tw.real
                        - np.sin(2 * np.pi * cycles) * tw.imag), axis=-1)
    assert y.shape == (channels, n)
    assert np.abs(y - ref).max() < 1e-3 * np.abs(ref).max()
