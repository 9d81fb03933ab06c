"""Sequence-parallel STFT vs single-chip, on the 8-device virtual mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flan_tpu.ops import stft
from flan_tpu.parallel.mesh import make_mesh
from flan_tpu.parallel.stft_sp import pv_forward_sp, pv_inverse_sp

SR = 8000.0
WINDOW, HOP, DFT = 256, 64, 256


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, axis_name="sp")


def test_forward_sp_matches_single(mesh):
    rng = np.random.default_rng(0)
    n = 8 * 64 * HOP  # 8 shards of 64 hops
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32) * 0.3)
    mag1, freq1 = stft.pv_forward(x, window_size=WINDOW, hop=HOP,
                                  dft_size=DFT, sample_rate=SR)
    mag8, freq8 = pv_forward_sp(x, mesh, window_size=WINDOW, hop=HOP,
                                dft_size=DFT, sample_rate=SR)
    nh = mag1.shape[1]
    np.testing.assert_allclose(np.asarray(mag8[:, :nh]),
                               np.asarray(mag1), atol=1e-3)
    np.testing.assert_allclose(np.asarray(freq8[:, :nh]),
                               np.asarray(freq1), atol=0.5)


def test_inverse_sp_matches_single(mesh):
    rng = np.random.default_rng(1)
    n = 8 * 64 * HOP
    t = np.arange(n, dtype=np.float32) / SR
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 440 * t))[None])
    mag, freq = pv_forward_sp(x, mesh, window_size=WINDOW, hop=HOP,
                              dft_size=DFT, sample_rate=SR)
    y1 = stft.pv_inverse(mag, freq, window_size=WINDOW, hop=HOP,
                         sample_rate=SR)
    y8 = pv_inverse_sp(mag, freq, mesh, window_size=WINDOW, hop=HOP,
                       sample_rate=SR)
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y1), atol=2e-3)


def test_sp_roundtrip_reconstructs(mesh):
    n = 8 * 64 * HOP
    t = np.arange(n, dtype=np.float32) / SR
    x = jnp.asarray((0.5 * np.sin(2 * np.pi * 330 * t))[None])
    mag, freq = pv_forward_sp(x, mesh, window_size=WINDOW, hop=HOP,
                              dft_size=DFT, sample_rate=SR)
    y = pv_inverse_sp(mag, freq, mesh, window_size=WINDOW, hop=HOP,
                      sample_rate=SR)
    guard = WINDOW * 2
    a = np.asarray(x[0, guard:n - guard])
    b = np.asarray(y[0, guard:n - guard])
    rel = np.sqrt(((a - b) ** 2).mean()) / np.sqrt((a ** 2).mean())
    assert rel < 0.05


def test_map_sharded_batch_matches_per_clip(mesh):
    """Data-parallel batch map equals per-clip application; 5 clips of
    mixed lengths over 8 devices (padding clips + batch)."""
    from flan_tpu.parallel.batch import map_sharded
    from flan_tpu.pipelines import pv_stretch_pipeline
    rng = np.random.default_rng(2)
    clips = [jnp.asarray(rng.standard_normal(
        (1, HOP * (40 + 8 * i))).astype(np.float32) * 0.3)
        for i in range(5)]
    fn = lambda x: pv_stretch_pipeline(
        x, 2.0, window_size=WINDOW, hop=HOP, dft_size=DFT, sample_rate=SR)
    outs = map_sharded(fn, clips, mesh=mesh)
    assert len(outs) == 5
    n = max(int(c.shape[-1]) for c in clips)
    for clip, out in zip(clips, outs):
        pad = jnp.pad(clip, [(0, 0), (0, n - int(clip.shape[-1]))])
        ref = fn(pad)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-4)


def test_stretch_batch_convenience(mesh):
    from flan_tpu.parallel.batch import stretch_batch
    rng = np.random.default_rng(3)
    clips = [jnp.asarray(rng.standard_normal((1, HOP * 48)).astype(
        np.float32) * 0.3) for _ in range(3)]
    outs = stretch_batch(clips, 2.0, mesh=mesh, window_size=WINDOW,
                         hop=HOP, dft_size=DFT, sample_rate=SR)
    assert len(outs) == 3
    for out, clip in zip(outs, clips):
        assert out.shape[-1] >= 2 * clip.shape[-1] - 4 * HOP
        assert np.isfinite(np.asarray(out)).all()


def test_linear_recurrence_sp_matches_single(mesh):
    """IIR boundary-state handoff (SURVEY.md section 5): sharded scalar recurrence equals the single-chip
    tiled scan."""
    from flan_tpu.ops.scan import linear_recurrence
    from flan_tpu.parallel.scan_sp import linear_recurrence_sp
    rng = np.random.default_rng(4)
    n = 8 * 1000 + 37  # non-multiple of the mesh: exercises identity pad
    a = jnp.asarray(rng.uniform(0.8, 0.999, (2, n)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32) * 0.1)
    y1 = linear_recurrence(a, b, y0=0.25)
    y8 = linear_recurrence_sp(a, b, mesh, y0=0.25)
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y1),
                               rtol=1e-4, atol=1e-4)


def test_matrix_recurrence_sp_matches_single(mesh):
    from flan_tpu.ops.scan import matrix_affine_recurrence
    from flan_tpu.parallel.scan_sp import matrix_affine_recurrence_sp
    rng = np.random.default_rng(5)
    c, t, k = 2, 8 * 500 + 13, 2
    # contractive random transitions (spectral radius < 1, like the SVF)
    A = jnp.asarray(
        (rng.standard_normal((c, t, k, k)) * 0.3).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((c, t, k)).astype(np.float32) * 0.1)
    y0 = jnp.asarray(rng.standard_normal((c, k)).astype(np.float32))
    y1 = matrix_affine_recurrence(A, b, y0)
    y8 = matrix_affine_recurrence_sp(A, b, y0, mesh)
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y1),
                               rtol=1e-4, atol=1e-4)


def test_filter_1pole_sp_matches_core(mesh):
    """The sharded TPT 1-pole lowpass equals the single-chip core, with a
    time-varying (per-sample) cutoff - the case the FIR fast path can't
    take."""
    from flan_tpu.ops.filter_cores import onepole_core
    from flan_tpu.parallel.scan_sp import filter_1pole_lowpass_sp
    rng = np.random.default_rng(6)
    n = 8 * 1024
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32) * 0.3)
    cutoff = jnp.asarray(
        (800.0 + 600.0 * np.sin(np.linspace(0, 6.0, n))).astype(np.float32))
    g = jnp.tan((np.pi / SR) * cutoff)
    lp1, _ = onepole_core(x, g[None, :])
    lp8 = filter_1pole_lowpass_sp(x, cutoff, SR, mesh)
    np.testing.assert_allclose(np.asarray(lp8), np.asarray(lp1),
                               rtol=1e-4, atol=1e-5)


def test_stretch_sp_streamed_matches_stretch_sp(mesh):
    """The streamed-SP composition equals the
    materializing stretch_sp; tail drift is the chunked mod-1 phase
    accumulator's f32 rounding (same growth as stretch_sp itself vs the
    single-chip pipeline)."""
    from flan_tpu.parallel.stft_sp import stretch_sp, stretch_sp_streamed
    rng = np.random.default_rng(3)
    n = 8 * 32 * HOP
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32) * 0.3)
    y_ref = stretch_sp(x, mesh, factor=2.0, window_size=WINDOW, hop=HOP,
                       dft_size=DFT, sample_rate=SR)
    y_st = stretch_sp_streamed(x, mesh, factor=2.0, window_size=WINDOW,
                               hop=HOP, dft_size=DFT, sample_rate=SR,
                               chunk_out=32)
    m = min(y_ref.shape[-1], y_st.shape[-1])
    np.testing.assert_allclose(np.asarray(y_st[:, :m]),
                               np.asarray(y_ref[:, :m]), atol=5e-3)


def test_stretch_sp_streamed_chunk_invariant(mesh):
    """Output is independent of the streaming chunk size (the scan carry
    chain is exact up to f32 reassociation)."""
    from flan_tpu.parallel.stft_sp import stretch_sp_streamed
    rng = np.random.default_rng(4)
    n = 8 * 32 * HOP
    x = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32) * 0.3)
    y16 = stretch_sp_streamed(x, mesh, factor=1.5, window_size=WINDOW,
                              hop=HOP, dft_size=DFT, sample_rate=SR,
                              chunk_out=16)
    y64 = stretch_sp_streamed(x, mesh, factor=1.5, window_size=WINDOW,
                              hop=HOP, dft_size=DFT, sample_rate=SR,
                              chunk_out=64)
    m = min(y16.shape[-1], y64.shape[-1])
    np.testing.assert_allclose(np.asarray(y16[:, :m]),
                               np.asarray(y64[:, :m]), atol=2e-3)


def test_stretch_sp_streamed_variable_factor(mesh):
    """Non-constant stretch factors route through the same host time map
    as stretch_sp."""
    from flan_tpu.parallel.stft_sp import stretch_sp, stretch_sp_streamed
    rng = np.random.default_rng(5)
    n = 8 * 32 * HOP
    x = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32) * 0.3)
    factor = lambda t: 1.0 + t  # noqa: E731
    y_ref = stretch_sp(x, mesh, factor=factor, window_size=WINDOW, hop=HOP,
                       dft_size=DFT, sample_rate=SR)
    y_st = stretch_sp_streamed(x, mesh, factor=factor, window_size=WINDOW,
                               hop=HOP, dft_size=DFT, sample_rate=SR,
                               chunk_out=32)
    m = min(y_ref.shape[-1], y_st.shape[-1])
    np.testing.assert_allclose(np.asarray(y_st[:, :m]),
                               np.asarray(y_ref[:, :m]), atol=5e-3)

def test_repitch_sp_streamed_matches_single_chip(mesh):
    """Streamed-SP repitch equals the single-chip
    streamed repitch pipeline on every shard."""
    from flan_tpu.parallel.stft_sp import repitch_sp_streamed
    from flan_tpu.pipelines.streamed import pv_repitch_pipeline
    rng = np.random.default_rng(5)
    n = 8 * 32 * HOP
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32) * 0.3)
    y_ref = pv_repitch_pipeline(x, 1.5, window_size=WINDOW, hop=HOP,
                                dft_size=DFT, sample_rate=SR, chunk_out=32)
    y_sp = repitch_sp_streamed(x, mesh, factor=1.5, window_size=WINDOW,
                               hop=HOP, dft_size=DFT, sample_rate=SR,
                               chunk_out=32)
    m = min(y_ref.shape[-1], y_sp.shape[-1])
    np.testing.assert_allclose(np.asarray(y_sp[:, :m]),
                               np.asarray(y_ref[:, :m]), atol=5e-3)


def test_morph_sp_streamed_matches_single_chip(mesh):
    """Streamed-SP two-source morph equals the single-chip streamed morph
    pipeline (replace_amplitudes semantics) on every shard."""
    from flan_tpu.parallel.stft_sp import morph_sp_streamed
    from flan_tpu.pipelines.streamed import pv_morph_pipeline
    rng = np.random.default_rng(6)
    n = 8 * 32 * HOP
    a = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32) * 0.3)
    b = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32) * 0.3)
    y_ref = pv_morph_pipeline(a, b, 0.5, window_size=WINDOW, hop=HOP,
                              dft_size=DFT, sample_rate=SR, chunk_out=32)
    y_sp = morph_sp_streamed(a, b, mesh, amount=0.5, window_size=WINDOW,
                             hop=HOP, dft_size=DFT, sample_rate=SR,
                             chunk_out=32)
    m = min(y_ref.shape[-1], y_sp.shape[-1])
    np.testing.assert_allclose(np.asarray(y_sp[:, :m]),
                               np.asarray(y_ref[:, :m]), atol=5e-3)


def test_convolve_sp_matches_single(mesh):
    """Time-domain halo-exchange convolution (parallel/conv_sp.py) vs the
    single-chip overlap-save core, including the final-tail handoff
    (reference analog: AudioCombination.cpp:299-353)."""
    from flan_tpu.ops.fft_conv import fft_convolve_full
    from flan_tpu.parallel.conv_sp import convolve_sp
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 8 * 300 + 17))
                    .astype(np.float32))
    ir = jnp.asarray((rng.standard_normal((2, 64)).astype(np.float32)
                      * np.exp(-np.arange(64, dtype=np.float32) / 16)))
    got = convolve_sp(x, ir, mesh, axis="sp")
    ref = fft_convolve_full(x, ir)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


def test_convolve_sp_rejects_oversized_tail(mesh):
    from flan_tpu.parallel.conv_sp import convolve_sp
    x = jnp.zeros((1, 80), jnp.float32)    # 10-sample shards on 8 devices
    ir = jnp.zeros((1, 64), jnp.float32)
    with pytest.raises(ValueError):
        convolve_sp(x, ir, mesh, axis="sp")
