"""Numerics gates: SNR checks of the precision-sensitive paths.

The test suite runs on the CPU, where every float32 matrix product is
full precision. On a GPU a product without an explicit `precision=` may
run in TF32 (about three decimal digits), which the CPU tests can never
catch. These gates run the same paths on whatever backend JAX selected
and compare them with float64 numpy references or analytic signals.
chip_smoke.py and bench.py both run them on the card.

Each gate returns a value in dB (higher is better); GATES pairs it with
its threshold. A TF32 collapse costs the FFT and resample gates 40-70 dB,
so the thresholds sit well above where reduced precision lands.
"""
from __future__ import annotations

import numpy as np


def snr_db(ref, got, fit_scale=True):
    """SNR of got vs ref after an optimal scalar fit (insensitive to the
    documented OLA gain conventions, sensitive to everything else)."""
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    ref, got = ref[:n], got[:n]
    if fit_scale:
        denom = float(got @ got)
        s = float(ref @ got) / denom if denom > 0 else 1.0
        got = got * s
    err = float(((ref - got) ** 2).mean())
    sig = float((ref ** 2).mean())
    return 10.0 * np.log10(max(sig, 1e-300) / max(err, 1e-300))


def aligned_snr_db(ref, got, guard=4096, n2=1 << 17):
    """Cross-correlation-aligned SNR (the sliding transforms carry a
    group delay of a few tens of samples)."""
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    aa = ref[guard:-guard]
    xc = np.fft.irfft(np.fft.rfft(aa, n2).conj()
                      * np.fft.rfft(got[guard:-guard], n2), n2)
    lag = int(np.argmax(xc))
    if lag > n2 // 2:
        lag -= n2
    bb = got[guard + lag: guard + lag + len(aa)]
    if len(bb) < len(aa):
        aa = aa[:len(bb)]
    return snr_db(aa, bb)


def gate_fft():
    """The phase vocoder's forward transform (ops/stft.rfft_mag_phase:
    rFFT plus polar extraction) vs numpy's float64 rFFT."""
    import jax.numpy as jnp
    from flan_tpu.ops.stft import rfft_mag_phase
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 4096)).astype(np.float32)
    mag, phase = rfft_mag_phase(jnp.asarray(x), 4096)
    got = (np.asarray(mag, np.float64)
           * np.exp(1j * np.asarray(phase, np.float64)))
    ref = np.fft.rfft(x.astype(np.float64))
    err = np.abs(got - ref) ** 2
    sig = np.abs(ref) ** 2
    return 10.0 * np.log10(sig.mean() / max(err.mean(), 1e-300))


def gate_pv_roundtrip():
    """Audio -> PV -> Audio identity (the reference's own fidelity oracle,
    AudioInformation.cpp:131-136 uses energy difference; SNR is strictly
    stronger). Covers the forward STFT, phase vocoder, inverse scan, OLA."""
    import jax.numpy as jnp
    from flan_tpu.ops import stft
    sr = 44100.0
    n = int(10.0 * sr)
    t = np.arange(n, dtype=np.float32) / sr
    rng = np.random.default_rng(1)
    x = (0.4 * np.sin(2 * np.pi * 220.0 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)[None]
    mag, freq = stft.pv_forward(jnp.asarray(x), window_size=1024, hop=256,
                                dft_size=1024, sample_rate=sr)
    y = np.asarray(stft.pv_inverse(mag, freq, window_size=1024, hop=256,
                                   sample_rate=sr))[0]
    g = 4096
    return snr_db(x[0][g:n - g], y[g:n - g])


def gate_spv():
    """SPV sliding-DFT round trip, aligned."""
    import jax.numpy as jnp
    from flan_tpu import Audio
    sr = 48000.0
    n = int(10.0 * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None]
    a = Audio(data=jnp.asarray(x), sample_rate=sr)
    y = np.asarray(a.convert_to_SPV(512).convert_to_audio().data)[0]
    return aligned_snr_db(x[0], y)


def gate_sqpv():
    """SQPV sliding constant-Q round trip, aligned."""
    import jax.numpy as jnp
    from flan_tpu import Audio
    sr = 48000.0
    n = int(5.0 * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None]
    a = Audio(data=jnp.asarray(x), sample_rate=sr)
    sq = a.convert_to_SQPV((16.0, 24000.0), 24.0)
    y = np.asarray(sq.convert_to_audio().data)[0]
    return aligned_snr_db(x[0], y, guard=8192)


def gate_resample():
    """44.1k -> 48k polyphase windowed-sinc (one einsum at
    precision=HIGHEST; ops/resample.py) vs the analytic target sine."""
    import jax.numpy as jnp
    from flan_tpu import Audio
    sr_in, sr_out = 44100.0, 48000.0
    n = int(2.0 * sr_in)
    t = np.arange(n, dtype=np.float32) / sr_in
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)[None]
    out = Audio(data=jnp.asarray(x), sample_rate=sr_in).resample(sr_out)
    y = np.asarray(out.data)[0]
    m = len(y)
    t2 = np.arange(m, dtype=np.float64) / sr_out
    ref = 0.5 * np.sin(2 * np.pi * 440.0 * t2)
    g = 2048
    return snr_db(ref[g:m - g], y[g:m - g])


def gate_stretch():
    """Headline fused stretch pipeline on a pure sine: the dominant
    output partial must stay at the input frequency with the rest of the
    spectrum suppressed (integration gate over forward+remap+inverse)."""
    import jax.numpy as jnp
    from flan_tpu.pipelines import pv_stretch_pipeline
    sr = 48000.0
    n = int(5.0 * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t),
                  0.4 * np.sin(2 * np.pi * 330.0 * t)]).astype(np.float32)
    y = np.asarray(pv_stretch_pipeline(jnp.asarray(x), 2.0,
                                       sample_rate=sr))
    g = 48000
    seg = y[0][g:g + (1 << 17)]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak_hz = np.argmax(spec) * sr / len(seg)
    inband = np.abs(np.fft.rfftfreq(len(seg), 1 / sr) - peak_hz) < 20.0
    sideband_db = 10 * np.log10(max((spec[~inband] ** 2).sum(), 1e-300)
                                / (spec[inband] ** 2).sum())
    if abs(peak_hz - 220.0) > 2.0:
        return -abs(peak_hz - 220.0)  # wrong partial: hard fail
    return -sideband_db  # dB of sideband suppression (higher = better)


# name -> (gate, threshold in dB). The thresholds are the CPU-calibrated
# clean values minus ~10 dB of headroom.
GATES = {
    "fft": (gate_fft, 90.0),
    "pv_roundtrip": (gate_pv_roundtrip, 35.0),
    "spv": (gate_spv, 20.0),
    "sqpv": (gate_sqpv, 10.0),
    "resample": (gate_resample, 55.0),
    "stretch": (gate_stretch, 15.0),
}


def run_gates(names=None):
    """{name: (value_db, threshold_db)} for the named gates (all by
    default). Exceptions propagate: a gate that cannot run has failed."""
    return {name: (float(GATES[name][0]()), GATES[name][1])
            for name in (names or GATES)}
