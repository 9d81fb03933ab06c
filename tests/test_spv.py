"""Sliding-DFT phase vocoder tests (reference AudioSPV.cpp, SPV.cpp)."""
import numpy as np
import pytest

from flan_tpu import Audio, SPV, SQPV

SR = 8000.0


def sine(freq, seconds=0.25, amp=0.5):
    t = np.arange(int(seconds * SR), dtype=np.float32) / SR
    return Audio.create_from_array(
        (amp * np.sin(2 * np.pi * freq * t))[None], SR)


def test_spv_shapes():
    a = sine(440.0)
    spv = a.convert_to_SPV(128)
    assert spv.num_frames == a.num_frames
    assert spv.num_bins == 128
    assert spv.analysis_rate == SR


def test_spv_roundtrip():
    a = sine(440.0)
    b = a.convert_to_SPV(128).convert_to_audio()
    n = a.num_frames
    guard = 512  # sliding window fill-in
    x = np.asarray(a.data[0, guard:n - guard])
    y = np.asarray(b.data[0, guard:n - guard])
    rel = np.sqrt(((x - y) ** 2).mean()) / np.sqrt((x ** 2).mean())
    assert rel < 0.1


def test_spv_frequency_estimate():
    a = sine(440.0)
    spv = a.convert_to_SPV(128)
    mid = spv.num_frames // 2
    m = np.asarray(spv.mag[0, mid])
    f = np.asarray(spv.freq[0, mid])
    assert abs(f[m.argmax()] - 440.0) < 10.0


def test_spv_repitch():
    a = sine(440.0)
    spv = a.convert_to_SPV(128).repitch(1.5)
    b = spv.convert_to_audio()
    mid = np.asarray(b.data[0, 800:1800])
    spec = np.abs(np.fft.rfft(mid))
    peak = spec.argmax() * SR / len(mid)
    assert abs(peak - 660.0) < 20.0


def test_sqpv_buffer():
    s = SQPV.create(1, 100, 24.0, SR, (16.0, 4000.0))
    assert not s.is_null()
    # log-spaced bins: frequency doubles every bins_per_octave bins
    assert s.bin_to_frequency(24) == pytest.approx(
        2 * s.bin_to_frequency(0), rel=1e-6)
    assert s.frequency_to_bin(s.bin_to_frequency(10)) == pytest.approx(
        10.0, abs=1e-6)
    assert s.q == pytest.approx(1.0 / (2 ** (1 / 24) - 1.0))


def test_sqpv_conversion_activated():
    # dormant upstream (AudioSQPV.cpp commented out) but activated here;
    # full coverage lives in tests/test_sqpv_transform.py
    a = sine(440.0)
    sq = a.convert_to_SQPV((55.0, 1760.0), 4)
    assert not sq.is_null()


def test_spv_roundtrip_bench_scale_aligned():
    """Round trip at the bench config's rate/bins (48 kHz, 512 bins).

    The sliding-window reconstruction carries a small constant lead
    (~34 samples at this config - group delay of the synthesis
    convention), so fidelity is asserted after cross-correlation
    alignment; unaligned sample-wise SNR is meaningless here (measured
    -4.5 dB for a perfectly reconstructed sine, round 3)."""
    from flan_tpu.spv.spv import spv_forward, spv_inverse
    import jax.numpy as jnp
    sr = 48000.0
    n = int(0.25 * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray((0.4 * np.sin(2 * np.pi * 440.0 * t))[None])
    mag, freq = spv_forward(x, 512, sr)
    y = spv_inverse(mag, freq, sr)
    a = np.asarray(x)[0][2048:-2048]
    b = np.asarray(y)[0][2048:-2048]
    n2 = 1 << 14
    xc = np.fft.irfft(np.fft.rfft(a, n2).conj() * np.fft.rfft(b, n2), n2)
    lag = int(np.argmax(xc))
    if lag > n2 // 2:
        lag -= n2
    assert abs(lag) < 128, lag
    b_al = np.asarray(y)[0][2048 + lag:2048 + lag + len(a)]
    err = ((a - b_al) ** 2).mean()
    snr = 10 * np.log10((a ** 2).mean() / max(err, 1e-30))
    assert snr > 25.0, snr


def _spv_forward_f64(x, nbins, sr):
    """Float64 sliding DFT + phase vocoder, written from the reference's
    equations (AudioSPV.cpp:47-92): one direct cumsum over all samples,
    the 3-tap hann stencil with its real-part edge reflection, then
    lag-1 phase differences wrapped around the bin's expected advance."""
    c, n = x.shape
    two_b = 2 * nbins
    x = x.astype(np.float64)
    delayed = np.concatenate([np.zeros((c, two_b)), x], axis=1)[:, :n]
    t = np.arange(n)[:, None]
    b = np.arange(nbins)[None, :]
    s = np.cumsum((x - delayed)[:, :, None]
                  * np.exp(-1j * np.pi * (t % two_b) * b / nbins)[None],
                  axis=1)
    f = s * np.exp(1j * np.pi * ((t + 1) % two_b) * b / nbins)[None]
    conv = 2.0 * f
    conv[..., 1:-1] -= f[..., :-2] + f[..., 2:]
    conv[..., 0] -= 2.0 * f[..., 1].real
    conv[..., -1] -= 2.0 * f[..., -2].real
    conv *= 0.25 / two_b
    mag = np.abs(conv)
    phase = np.angle(conv)
    prev = np.concatenate([np.zeros((c, 1, nbins)), phase[:, :-1]], axis=1)
    d = phase - prev - np.pi * b[None] / nbins
    d -= 2 * np.pi * np.round(d / (2 * np.pi))
    freq = b[None] * sr / two_b + d * sr / (2 * np.pi)
    return mag, freq


@pytest.mark.parametrize("nbins", [16, 64])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [700, 1337])
def test_spv_scan_matches_float64_reference(nbins, channels, n):
    """The chunked scan (carried sums across 256-frame chunks, triangular
    prefix sums, periodic twiddle table) equals the direct float64
    transform on ragged lengths."""
    from flan_tpu.spv.spv import spv_forward
    import jax.numpy as jnp
    rng = np.random.default_rng(nbins + channels + n)
    x = (0.3 * rng.standard_normal((channels, n))).astype(np.float32)
    mag, freq = spv_forward(jnp.asarray(x), nbins, SR, chunk=256)
    mag_ref, freq_ref = _spv_forward_f64(x, nbins, SR)
    mag, freq = np.asarray(mag), np.asarray(freq)
    assert mag.shape == freq.shape == (channels, n, nbins)
    scale = mag_ref.max()
    assert np.abs(mag - mag_ref).max() < 1e-4 * scale
    strong = mag_ref > 1e-2 * scale
    dfreq = np.abs(freq - freq_ref)[strong]
    dfreq = np.minimum(dfreq, np.abs(dfreq - SR))  # a +-pi wrap is SR Hz
    assert dfreq.max() < 1e-3 * SR


@pytest.mark.parametrize("channels,n", [(1, 700), (2, 1337)])
def test_spv_inverse_matches_float64_reference(channels, n):
    """Phase accumulation + alternating-sign real sum
    (AudioSPV.cpp:113-145) vs float64 numpy."""
    from flan_tpu.spv.spv import spv_inverse
    import jax.numpy as jnp
    nbins = 32
    rng = np.random.default_rng(n)
    mag = rng.random((channels, n, nbins)).astype(np.float32)
    freq = rng.uniform(-SR / 2, SR / 2, (channels, n, nbins)).astype(
        np.float32)
    y = np.asarray(spv_inverse(jnp.asarray(mag), jnp.asarray(freq), SR))
    cycles = np.mod(np.cumsum(freq.astype(np.float64) / SR, axis=1), 1.0)
    sign = np.where(np.arange(nbins) % 2 == 0, 1.0, -1.0)
    ref = 2.0 * np.sum(mag * np.cos(2 * np.pi * cycles) * sign, axis=-1)
    assert y.shape == (channels, n)
    assert np.abs(y - ref).max() < 1e-3 * np.abs(ref).max()
