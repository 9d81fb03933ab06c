"""Fused streaming stretch pipeline vs the unfused path."""
import numpy as np
import pytest

import jax.numpy as jnp

from flan_tpu import Audio
from flan_tpu.pipelines import pv_stretch_pipeline

SR = 8000.0
WINDOW, HOP, DFT = 256, 64, 256


def test_fused_matches_unfused():
    rng = np.random.default_rng(0)
    t = np.arange(4000, dtype=np.float32) / SR
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 220 * t)]).astype(np.float32)
    a = Audio.create_from_array(x, SR)
    unfused = a.convert_to_PV(WINDOW, HOP, DFT).stretch(
        2.0).convert_to_audio()
    fused = pv_stretch_pipeline(
        a.data, 2.0, window_size=WINDOW, hop=HOP, dft_size=DFT,
        sample_rate=SR, chunk_out=32)
    uf = np.asarray(unfused.data)
    fu = np.asarray(fused)
    n = min(uf.shape[-1], fu.shape[-1])
    # the two paths batch the same transforms differently, so they agree
    # only to accumulated f32 rounding; the dense small-FFT path rounds
    # slightly differently than the two-stage form (observed max ~3.5e-4
    # on a 0.5-peak signal, i.e. -63 dB)
    np.testing.assert_allclose(fu[:, :n], uf[:, :n], atol=6e-4)


def test_fused_variable_factor():
    t = np.arange(2000, dtype=np.float32) / SR
    x = (0.5 * np.sin(2 * np.pi * 330 * t))[None].astype(np.float32)
    a = Audio.create_from_array(x, SR)
    factor = lambda tt: 1.0 + 0.5 * tt  # accelerating stretch
    unfused = a.convert_to_PV(WINDOW, HOP, DFT).stretch(
        lambda tt, f: 1.0 + 0.5 * tt).convert_to_audio()
    fused = pv_stretch_pipeline(
        x, factor, window_size=WINDOW, hop=HOP, dft_size=DFT,
        sample_rate=SR, chunk_out=16)
    uf = np.asarray(unfused.data)
    fu = np.asarray(fused)
    n = min(uf.shape[-1], fu.shape[-1])
    np.testing.assert_allclose(fu[:, :n], uf[:, :n], atol=2e-4)


def test_repitch_pipeline_matches_unfused():
    """Fused streaming repitch == convert_to_PV >> repitch >>
    convert_to_audio."""
    from flan_tpu.pipelines import pv_repitch_pipeline
    sr = 8000.0
    n = 2 * 8000
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 440 * t))[None])
    a = Audio(data=x, sample_rate=sr)
    fused = pv_repitch_pipeline(x, 1.5, window_size=512, hop=64,
                                dft_size=512, sample_rate=sr)
    unfused = a.convert_to_PV(512, 64, 512).repitch(1.5) \
        .convert_to_audio().data
    m = min(fused.shape[-1], unfused.shape[-1])
    np.testing.assert_allclose(np.asarray(fused[:, :m]),
                               np.asarray(unfused[:, :m]), atol=1e-3)


def test_morph_pipeline_matches_unfused():
    """Fused streaming morph == replace_amplitudes path
    (reference PV.cpp:205-236)."""
    from flan_tpu.pipelines import pv_morph_pipeline
    sr = 8000.0
    n = 2 * 8000
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 440 * t))[None])
    y = jnp.asarray((0.4 * np.sin(2 * np.pi * 620 * t))[None])
    a = Audio(data=x, sample_rate=sr)
    b = Audio(data=y, sample_rate=sr)
    amt = lambda tt, ff: jnp.clip(tt / 2.0, 0.0, 1.0)
    fused = pv_morph_pipeline(x, y, amt, window_size=512, hop=64,
                              dft_size=512, sample_rate=sr)
    unfused = a.convert_to_PV(512, 64, 512).replace_amplitudes(
        b.convert_to_PV(512, 64, 512), amt).convert_to_audio().data
    m = min(fused.shape[-1], unfused.shape[-1])
    np.testing.assert_allclose(np.asarray(fused[:, :m]),
                               np.asarray(unfused[:, :m]), atol=1e-3)


def test_morph_pipeline_mismatched_lengths():
    """When b is shorter than a, frames beyond b's extent must be silent
    (replace_amplitudes zero-fills beyond min_frames; round-2 review
    finding 4) - not (1-amt)-scaled a-content."""
    from flan_tpu.pipelines import pv_morph_pipeline
    sr = 8000.0
    na, nb = 2 * 8000, 8000
    t = np.arange(na, dtype=np.float32) / sr
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 440 * t))[None])
    y = jnp.asarray((0.4 * np.sin(2 * np.pi * 620 * t[:nb]))[None])
    a = Audio(data=x, sample_rate=sr)
    b = Audio(data=y, sample_rate=sr)
    amt = 0.25  # constant blend: a keeps 75% where b exists
    fused = pv_morph_pipeline(x, y, amt, window_size=512, hop=64,
                              dft_size=512, sample_rate=sr)
    unfused = a.convert_to_PV(512, 64, 512).replace_amplitudes(
        b.convert_to_PV(512, 64, 512), amt).convert_to_audio().data
    m = min(fused.shape[-1], unfused.shape[-1])
    np.testing.assert_allclose(np.asarray(fused[:, :m]),
                               np.asarray(unfused[:, :m]), atol=1e-3)
    # the tail (well past b plus the OLA window) must be silent
    tail = np.asarray(fused[:, nb + 2048:])
    assert np.abs(tail).max() < 1e-3


def test_repitch_pipeline_variable_factor_matches_unfused():
    """A callable factor takes the general (per-chunk searchsorted) path;
    the constant path above takes the host-precomputed one - both must
    match the unfused op."""
    from flan_tpu.pipelines import pv_repitch_pipeline
    sr = 8000.0
    n = 2 * 8000
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 440 * t))[None])
    a = Audio(data=x, sample_rate=sr)
    factor = lambda tt, ff: 1.2 + 0.3 * jnp.clip(tt / 2.0, 0.0, 1.0)
    fused = pv_repitch_pipeline(x, factor, window_size=512, hop=64,
                                dft_size=512, sample_rate=sr)
    unfused = a.convert_to_PV(512, 64, 512).repitch(factor) \
        .convert_to_audio().data
    m = min(fused.shape[-1], unfused.shape[-1])
    np.testing.assert_allclose(np.asarray(fused[:, :m]),
                               np.asarray(unfused[:, :m]), atol=1e-3)
