"""Algorithm-layer parity vs the COMPILED reference.

Fixtures in tests/fixtures/reference/algo_* and sdft_* were generated by
tools/reference_oracle/gen_algo_fixtures.cpp, which compiles the reference's
ACTUAL algorithm layer out-of-tree:

  PV/PVModify.cpp   stretch / modify_frequency / quad modify (the MIMM
                    endpoint policy, PVModify.cpp:154-172, 230-243) /
                    repitch / modify_time
  PV/PV.cpp         select / add_harmonics (scatter-max, PV.cpp:383-405)
  Conversions/AudioSPV.cpp  sliding-DFT forward (:24-106) + inverse
                    (:113-145)

These are the semantics the whole library is judged on; before this file
they were verified only against hand-read citations.

Every mod function here mirrors its C++ twin in gen_algo_fixtures.cpp using
float32 arithmetic with NO transcendentals, so grids and branch decisions
(floor/ceil/int casts) are reproducible.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from flan_tpu.pv.pv import PV
from flan_tpu.audio.audio import Audio
from flan_tpu.spv.spv import SPV

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(FIXDIR, "algo_in.dims")),
    reason="algorithm fixtures not generated")

# input PV: C=2 F=24 B=17, sr=8000, hop=8 (analysis_rate=1000), window=32,
# dft=32 -> bin width 250 Hz (gen_algo_fixtures.cpp make_input_pv)
C, F, B = 2, 24, 17
SR, HOP, WIN = 8000.0, 8, 32


def _planes(name):
    dims = tuple(int(x) for x in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    mag = np.fromfile(os.path.join(FIXDIR, name + "_mag.f32"),
                      dtype="<f4").reshape(dims)
    freq = np.fromfile(os.path.join(FIXDIR, name + "_freq.f32"),
                       dtype="<f4").reshape(dims)
    return mag, freq


def _input_pv() -> PV:
    i = np.arange(C * F * B, dtype=np.uint64)
    h = (i * np.uint64(2654435761)).astype(np.uint32)
    h2 = ((i + np.uint64(131)) * np.uint64(2246822519)).astype(np.uint32)
    m = (h % np.uint32(1000)).astype(np.float32) / np.float32(1000.0)
    jit = (h2 % np.uint32(2001)).astype(np.float32) / np.float32(1000.0) \
        - np.float32(1.0)
    b = (i % np.uint64(B)).astype(np.float32)
    fr = (b + np.float32(0.45) * jit) * np.float32(250.0)
    return PV(mag=jnp.asarray(m.reshape(C, F, B)),
              freq=jnp.asarray(fr.reshape(C, F, B)),
              sample_rate=SR, hop_size=HOP, window_size=WIN)


def test_input_pv_is_bit_reproducible():
    """The numpy recipe must equal the C++ generator's tensor bit-for-bit,
    proving the comparisons below run on a shared input."""
    ref_m, ref_f = _planes("algo_in")
    pv = _input_pv()
    assert np.array_equal(np.asarray(pv.mag), ref_m)
    assert np.array_equal(np.asarray(pv.freq), ref_f)


def _assert_planes_close(ours: PV, name, mag_tol=1e-4, freq_tol=1e-2,
                         mag_floor=1e-5):
    ref_m, ref_f = _planes(name)
    got_m = np.asarray(ours.mag)
    got_f = np.asarray(ours.freq)
    assert got_m.shape == ref_m.shape, (
        f"{name}: shape {got_m.shape} != reference {ref_m.shape}")
    np.testing.assert_allclose(got_m, ref_m, rtol=mag_tol, atol=mag_tol,
                               err_msg=f"{name}: magnitude plane")
    # frequency only matters where the reference kept energy
    live = ref_m > mag_floor
    np.testing.assert_allclose(got_f[live], ref_f[live], rtol=freq_tol,
                               atol=freq_tol * 250.0,
                               err_msg=f"{name}: frequency plane")


class TestModifyTimeFamily:
    def test_stretch_constant2(self):
        _assert_planes_close(_input_pv().stretch(lambda t, f: 2.0),
                             "algo_stretch2")

    def test_stretch_varying(self):
        def factor(t, f):
            t = jnp.float32(t) if np.isscalar(t) else t
            return 1.0 + ((0.5 * t) * 41.0) / 43.0
        _assert_planes_close(_input_pv().stretch(factor), "algo_stretch_var")

    def test_modify_time(self):
        def mod(t, f):
            return t * (1.5 + (0.5 / 4000.0) * f)
        _assert_planes_close(_input_pv().modify_time(mod), "algo_modtime")


class TestModifyFrequencyFamily:
    def test_modify_frequency_constant_ratio(self):
        _assert_planes_close(
            _input_pv().modify_frequency(lambda t, f: f * 1.3),
            "algo_modfreq_const")

    def test_modify_frequency_varying(self):
        def mod(t, f):
            return f * (0.7 + ((0.09 * t) * 257.0) / 4.0)
        _assert_planes_close(_input_pv().modify_frequency(mod),
                             "algo_modfreq_var")

    def test_repitch(self):
        _assert_planes_close(_input_pv().repitch(lambda t, f: 1.5),
                             "algo_repitch15")


class TestQuadModify:
    def test_modify_linear(self):
        def mod(t, f):
            return (t * 1.2 + 0.001, f * 0.8 + 50.0)
        _assert_planes_close(_input_pv().modify(mod), "algo_modify_lin")

    def test_modify_warped(self):
        def mod(t, f):
            t2 = t * (1.0 + 0.125 * t) + f * (0.25 / 4000.0) * t
            f2 = f * (0.9 - 0.25 * t) + 125.0
            return (t2, f2)
        _assert_planes_close(_input_pv().modify(mod), "algo_modify_warp")


class TestSelectAndHarmonics:
    def test_select(self):
        def selector(t, f):
            return (t * 0.5 + 0.002, f * 0.9)
        _assert_planes_close(_input_pv().select(0.030, selector),
                             "algo_select")

    def test_add_harmonics(self):
        _assert_planes_close(
            _input_pv().add_harmonics(lambda t, h: 1.0 / (1.0 + h)),
            "algo_harmonics")


class TestSlidingDFT:
    """AudioSPV.cpp:24-106 forward and :113-145 inverse vs compiled ref."""

    def _sig(self):
        return np.fromfile(os.path.join(FIXDIR, "sdft_sig.f32"), dtype="<f4")

    def test_forward_matches_reference(self):
        sig = self._sig()
        a = Audio(data=jnp.asarray(sig)[None], sample_rate=SR)
        spv = a.convert_to_SPV(16)
        ref_m, ref_f = _planes("sdft_fwd")
        got_m = np.asarray(spv.mag)
        got_f = np.asarray(spv.freq)
        assert got_m.shape == ref_m.shape
        # mag: absolute tolerance scaled by the spectrum peak (~0.12)
        np.testing.assert_allclose(got_m, ref_m, atol=2e-4,
                                   err_msg="sdft forward magnitude")
        # The reference skips phase wrapping when analysis_rate ==
        # sample_rate (phase_vocoder.cpp:37), leaving +-sample_rate
        # aliases in its frequencies; our SPV wraps deliberately
        # (flan_tpu/spv/spv.py, documented deviation). The planes are
        # equivalent mod sample_rate - compare wrap-aware.
        live = ref_m > 1e-3
        d = got_f[live] - ref_f[live]
        d = d - SR * np.round(d / SR)
        np.testing.assert_allclose(d, 0.0, atol=2.0,
                                   err_msg="sdft forward frequency")

    def test_inverse_matches_reference(self):
        ref_m, ref_f = _planes("sdft_fwd")
        spv = SPV(mag=jnp.asarray(ref_m), freq=jnp.asarray(ref_f),
                  sample_rate=SR)
        inv = np.asarray(spv.convert_to_audio().data)[0]
        ref_inv = np.fromfile(os.path.join(FIXDIR, "sdft_inv.f32"),
                              dtype="<f4")
        assert inv.shape == ref_inv.shape
        np.testing.assert_allclose(inv, ref_inv, atol=2e-3,
                                   err_msg="sdft inverse audio")


# ===========================================================================
# AudioFilter.cpp goldens: the 1,262-LoC filter family
# vs the COMPILED reference (previously analytic-response-only).
# ===========================================================================

def _audio_fixture(name):
    dims = tuple(int(x) for x in
                 open(os.path.join(FIXDIR, name + ".dims")).read().split())
    return np.fromfile(os.path.join(FIXDIR, name + ".f32"),
                       dtype="<f4").reshape(dims)


def _filter_input() -> Audio:
    return Audio(data=jnp.asarray(_audio_fixture("filt_sig")),
                 sample_rate=8000.0)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    n = min(len(ref), len(got))
    err = float(((ref[:n] - got[:n]) ** 2).mean())
    sig = float((ref[:n] ** 2).mean())
    return 10.0 * np.log10(max(sig, 1e-300) / max(err, 1e-300))


def _assert_filter_golden(out: Audio, name, snr_db=60.0):
    ref = _audio_fixture(name)
    got = np.asarray(out.data)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    snr = _snr_db(ref, got)
    assert snr >= snr_db, f"{name}: SNR {snr:.1f} dB < {snr_db}"


class TestFilterGoldens:
    def test_1pole_lowpass_order3(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_lowpass(800.0, 3), "filt_1p_lp3")

    def test_1pole_highpass_order2(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_highpass(500.0, 2), "filt_1p_hp2")

    def test_1pole_lowshelf(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_lowshelf(500.0, -9.0, 1),
            "filt_1p_ls")

    def test_1pole_highshelf_order2(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_highshelf(1000.0, 6.0, 2),
            "filt_1p_hs2")

    def test_1pole_repeat_low(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_repeat_low(800.0, 3),
            "filt_1p_rep")

    def test_2pole_lowpass_order2(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_lowpass(1200.0, 0.3, 2),
            "filt_2p_lp2")

    def test_2pole_lowpass_time_varying_cutoff(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_lowpass(
                lambda t: 400.0 + 20000.0 * t, 0.5, 1),
            "filt_2p_lp_var")

    def test_2pole_bandpass(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_bandpass(900.0, 0.5, 1),
            "filt_2p_bp")

    def test_2pole_highpass(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_highpass(600.0, 0.4, 1),
            "filt_2p_hp")

    def test_2pole_notch(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_notch(700.0, 0.2, 1),
            "filt_2p_notch")

    def test_2pole_lowshelf(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_lowshelf(500.0, 0.5, -6.0, 1),
            "filt_2p_ls")

    def test_2pole_bandshelf(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_bandshelf(1000.0, 0.4, 5.0, 1),
            "filt_2p_bs")

    def test_2pole_highshelf(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_highshelf(1500.0, 0.4, 5.0, 1),
            "filt_2p_hs")

    def test_1pole_multinotch(self):
        _assert_filter_golden(
            _filter_input().filter_1pole_multinotch(
                2, 800.0, 0.3, False, 0.5, False), "filt_1p_mn")

    def test_2pole_multinotch(self):
        _assert_filter_golden(
            _filter_input().filter_2pole_multinotch(
                2, 800.0, 0.35, 0.3, False, 0.5, False), "filt_2p_mn")

    def test_comb(self):
        _assert_filter_golden(
            _filter_input().filter_comb(1000.0, 0.5, 0.5, False),
            "filt_comb")

    def test_comb_inverted(self):
        _assert_filter_golden(
            _filter_input().filter_comb(1000.0, 0.25, 0.5, True),
            "filt_comb_inv")

    def test_shift_frequency(self):
        _assert_filter_golden(
            _filter_input().shift_frequency(123.0, 30.0), "filt_shift",
            snr_db=40.0)


# ===========================================================================
# Round-5 extension: the remaining algorithm families vs the COMPILED
# reference — volume/dynamics (AudioVolume.cpp), combination
# (AudioCombination.cpp), temporal incl. the WDL repitch
# (AudioTemporal.cpp), spatial (AudioSpatial.cpp), synthesis
# (AudioSynthesis.cpp), information (AudioInformation.cpp), and the
# whole-buffer r8brain resample (Audio::resample). Same shared input as
# the filter goldens (filt_sig).
# ===========================================================================

_NEW_FAMILIES = os.path.isfile(os.path.join(FIXDIR, "vol_mod.dims"))
needs_r5_fixtures = pytest.mark.skipif(
    not _NEW_FAMILIES, reason="round-5 algorithm fixtures not generated")


@needs_r5_fixtures
class TestVolumeGoldens:
    """AudioVolume.cpp:15-321 vs compiled reference."""

    def test_modify_volume_varying(self):
        _assert_filter_golden(
            _filter_input().modify_volume(lambda t: 0.25 + 8.0 * t),
            "vol_mod", snr_db=100.0)

    def test_set_volume(self):
        _assert_filter_golden(_filter_input().set_volume(0.5),
                              "vol_set", snr_db=100.0)

    def test_fade(self):
        _assert_filter_golden(_filter_input().fade(0.008, 0.012),
                              "vol_fade", snr_db=100.0)

    def test_invert_phase(self):
        _assert_filter_golden(_filter_input().invert_phase(),
                              "vol_invert", snr_db=120.0)

    def test_waveshape_oversampled(self):
        # oversample=2 routes through resample: the reference uses
        # r8brain, we use the polyphase windowed sinc — passband-equal,
        # not bit-equal
        _assert_filter_golden(
            _filter_input().waveshape(lambda t, x: x - x * x * x / 3.0, 2),
            "vol_waveshape", snr_db=40.0)

    def test_compress(self):
        _assert_filter_golden(
            _filter_input().compress(-12.0, 4.0, 0.005, 0.02, 6.0, None),
            "vol_compress", snr_db=60.0)

    def test_adsr(self):
        _assert_filter_golden(
            _filter_input().apply_adsr_envelope(
                0.01, 0.01, 0.02, 0.015, 0.5, 2.0, 0.5, 1.0),
            "vol_adsr", snr_db=80.0)


@needs_r5_fixtures
class TestTemporalGoldens:
    """AudioTemporal.cpp vs compiled reference (incl. WDL Sinc repitch)."""

    def test_reverse(self):
        _assert_filter_golden(_filter_input().reverse(), "temp_reverse",
                              snr_db=120.0)

    def test_cut(self):
        _assert_filter_golden(_filter_input().cut(0.01, 0.05), "temp_cut",
                              snr_db=120.0)

    def test_repitch_constant(self):
        _assert_filter_golden(
            _filter_input().repitch(1.5, 0.001), "temp_repitch_c",
            snr_db=40.0)

    def test_repitch_varying(self):
        _assert_filter_golden(
            _filter_input().repitch(lambda t: 0.75 + 8.0 * t, 0.001),
            "temp_repitch_v", snr_db=40.0)

    def test_iterate(self):
        _assert_filter_golden(_filter_input().iterate(3), "temp_iterate",
                              snr_db=120.0)


@needs_r5_fixtures
class TestCombinationGoldens:
    """AudioCombination.cpp vs compiled reference."""

    def _pair(self):
        a = _filter_input()
        return a, a.reverse()

    def test_mix(self):
        a, arev = self._pair()
        out = Audio.mix([a, arev], [0.0, 0.01],
                        [lambda t: 1.0 - 4.0 * t, 0.5])
        _assert_filter_golden(out, "comb_mix", snr_db=80.0)

    def test_join(self):
        a, arev = self._pair()
        _assert_filter_golden(Audio.join([a, arev], 0.005), "comb_join",
                              snr_db=80.0)

    def test_select(self):
        a, arev = self._pair()
        _assert_filter_golden(
            Audio.select([a, arev], lambda t: 16.0 * t), "comb_select",
            snr_db=80.0)

    def test_convolve(self):
        ir = Audio(data=jnp.asarray(
            np.fromfile(os.path.join(FIXDIR, "comb_ir.f32"),
                        dtype="<f4"))[None], sample_rate=8000.0)
        _assert_filter_golden(_filter_input().convolve(ir),
                              "comb_convolve", snr_db=60.0)


@needs_r5_fixtures
class TestSpatialGoldens:
    """AudioSpatial.cpp vs compiled reference."""

    def test_pan_constant(self):
        _assert_filter_golden(_filter_input().pan(0.6), "spat_pan_c",
                              snr_db=80.0)

    def test_pan_varying(self):
        _assert_filter_golden(
            _filter_input().pan(lambda t: -1.0 + 31.25 * t), "spat_pan_v",
            snr_db=80.0)

    def test_widen(self):
        _assert_filter_golden(_filter_input().widen(0.7), "spat_widen",
                              snr_db=80.0)

    def test_spatialize(self):
        mono = _filter_input().convert_to_mono()
        out = mono.stereo_spatialize(lambda t: (1.0 - 10.0 * t, 2.0))
        _assert_filter_golden(out, "spat_spatialize", snr_db=40.0)

    def test_spatialize_stereo_is_null(self):
        # parity with the reference guard: stereo input -> null Audio
        assert _filter_input().stereo_spatialize(
            lambda t: (0.0, 1.0)).is_null()


@needs_r5_fixtures
class TestResampleSynthesisGoldens:
    """Audio::resample (r8brain) and synthesize_waveform vs compiled
    reference. Ours is a polyphase windowed-sinc redesign, so the bar is
    passband equality (SNR), not bit equality."""

    def test_resample(self):
        _assert_filter_golden(_filter_input().resample(11025.0),
                              "conv_resample", snr_db=40.0)

    def test_synthesize_waveform(self):
        def tri(p):
            return jnp.where(p < 0.5, 4.0 * p - 1.0, 3.0 - 4.0 * p)
        out = Audio.synthesize_waveform(tri, 0.064, 220.0, 8000.0, 2)
        _assert_filter_golden(out, "synth_wave", snr_db=40.0)


@needs_r5_fixtures
class TestInformationGoldens:
    """AudioInformation.cpp vs compiled reference."""

    def test_local_wavelengths(self):
        wl = np.asarray(_filter_input().get_local_wavelengths(
            0, 0, -1, 256, 64))
        ref = np.fromfile(os.path.join(FIXDIR, "info_wavelengths.f32"),
                          dtype="<f4")
        assert wl.shape == ref.shape
        np.testing.assert_allclose(wl, ref, rtol=1e-3)

    def test_amplitude_envelope(self):
        env = _filter_input().get_amplitude_envelope(0.02)
        t = np.arange(512, dtype=np.float32) / 8000.0
        got = np.asarray(env(jnp.asarray(t)))
        ref = np.fromfile(os.path.join(FIXDIR, "info_amp_env.f32"),
                          dtype="<f4")
        assert _snr_db(ref, got) >= 40.0

    def test_total_energy(self):
        en = np.asarray(_filter_input().get_total_energy())
        ref = np.fromfile(os.path.join(FIXDIR, "info_energy.f32"),
                          dtype="<f4")
        np.testing.assert_allclose(en, ref, rtol=1e-4)


# ===========================================================================
# Round-5b extension: the remaining PV surface vs the COMPILED reference —
# utility/combination/generation (PV.cpp:24-270, 271-356, 421-731), the
# modify extras (PVModify.cpp:387-657), and the melodia family
# (PVInformation.cpp: get_salience :28-109, get_contours :111-263,
# prism :265-421). The melodia fixtures run on a tonal 96-frame PV
# (gen_algo_fixtures.cpp make_tonal_pv) loaded from its own dumped planes,
# so no float transcendental needs bit-reproduction in numpy.
# ===========================================================================

_R5B = os.path.isfile(os.path.join(FIXDIR, "algo_freeze.dims"))
needs_r5b_fixtures = pytest.mark.skipif(
    not _R5B, reason="round-5b PV fixtures not generated")


def _input_pv2() -> PV:
    """Seed-997 variant of _input_pv (gen_algo_fixtures.cpp
    make_input_pv(997)); used as the amp_source operand."""
    i = np.arange(C * F * B, dtype=np.uint64)
    h = ((i + np.uint64(997)) * np.uint64(2654435761)).astype(np.uint32)
    h2 = ((i + np.uint64(997 + 131))
          * np.uint64(2246822519)).astype(np.uint32)
    m = (h % np.uint32(1000)).astype(np.float32) / np.float32(1000.0)
    jit = (h2 % np.uint32(2001)).astype(np.float32) / np.float32(1000.0) \
        - np.float32(1.0)
    b = (i % np.uint64(B)).astype(np.float32)
    fr = (b + np.float32(0.45) * jit) * np.float32(250.0)
    return PV(mag=jnp.asarray(m.reshape(C, F, B)),
              freq=jnp.asarray(fr.reshape(C, F, B)),
              sample_rate=SR, hop_size=HOP, window_size=WIN)


def _tonal_pv() -> PV:
    """The melodia-family input, loaded from its own reference dump."""
    m, f = _planes("algo_tonal_in")
    return PV(mag=jnp.asarray(m), freq=jnp.asarray(f),
              sample_rate=SR, hop_size=HOP, window_size=WIN)


@needs_r5b_fixtures
class TestPVUtilityGoldens:
    """PV.cpp utility/combination surface vs compiled reference."""

    def test_freeze(self):
        _assert_planes_close(
            _input_pv().freeze([0.004, 0.012], [0.003, 0.005]),
            "algo_freeze")

    def test_get_frame(self):
        _assert_planes_close(_input_pv().get_frame(0.0105),
                             "algo_getframe")

    def test_replace_amplitudes(self):
        _assert_planes_close(
            _input_pv().replace_amplitudes(
                _input_pv2(), lambda t, f: 0.25 + 20.0 * t),
            "algo_replace_amp")

    def test_subtract_amplitudes(self):
        _assert_planes_close(
            _input_pv().subtract_amplitudes(_input_pv2(), 0.5),
            "algo_subtract_amp")

    def test_cut_frames(self):
        _assert_planes_close(_input_pv().cut_frames(5, 17), "algo_cutf")

    def test_join(self):
        pv = _input_pv()
        _assert_planes_close(
            PV.join([pv.cut_frames(0, 10), pv.cut_frames(10, 24)]),
            "algo_pvjoin")


@needs_r5b_fixtures
class TestPVGenerationGoldens:
    """PV.cpp generation surface vs compiled reference."""

    def test_synthesize(self):
        out = PV.synthesize(
            0.02, lambda t: 400.0 + 3000.0 * t,
            lambda t, h: 1.0 / (1.0 + h),
            harmonic_bandwidth=120.0, harmonic_frequency_std_dev=0.0)
        _assert_planes_close(out, "algo_synth")

    def test_shape_shift_aligned(self):
        _assert_planes_close(
            _input_pv().shape(
                lambda m, f: (m * 0.7 + 0.1, f * 0.95 + 30.0), True),
            "algo_shape_t")

    def test_shape_unaligned(self):
        _assert_planes_close(
            _input_pv().shape(
                lambda m, f: (m * 0.7 + 0.1, f * 0.95 + 30.0), False),
            "algo_shape_f")

    def test_shape_tie_break(self):
        """CONSTANT shaped magnitude forces equal-magnitude collisions
        on shared target bins: the sequential strict-> write keeps the
        LOWEST source bin's frequency (PV.cpp:446-448); a freq
        scatter-max diverges here (fixed after a round-5 review)."""
        skip_unless = os.path.isfile(
            os.path.join(FIXDIR, "algo_shape_tie.dims"))
        if not skip_unless:
            pytest.skip("tie fixtures not generated")
        _assert_planes_close(
            _input_pv().shape(
                lambda m, f: (jnp.full_like(m, 0.5), f * 0.9 + 40.0),
                True),
            "algo_shape_tie")

    def test_retain_n_loudest(self):
        _assert_planes_close(
            _input_pv().retain_n_loudest_partials(
                lambda t: 2 + t * 250.0), "algo_retain")

    def test_remove_n_loudest(self):
        _assert_planes_close(
            _input_pv().remove_n_loudest_partials(
                lambda t: 2 + t * 250.0), "algo_remove")

    def test_resonate(self):
        _assert_planes_close(
            _input_pv().resonate(0.04, lambda t, f: 0.3 + 10.0 * t),
            "algo_resonate")


@needs_r5b_fixtures
class TestPVModifyExtraGoldens:
    """PVModify.cpp:387-657 extras vs compiled reference."""

    def test_stretch_spline(self):
        _assert_planes_close(
            _input_pv().stretch_spline(lambda t: 2.0 + 30.0 * t),
            "algo_spline")

    def test_desample(self):
        _assert_planes_close(
            _input_pv().desample(lambda t, f: 0.4 + 10.0 * t),
            "algo_desample")

    def test_smear_time(self):
        _assert_planes_close(
            _input_pv().smear_time(
                lambda t, f: 0.004, 2,
                lambda t: 0.5 * (1.0 + jnp.cos(jnp.pi * t))),
            "algo_smear")

    def test_smear_time_odd_extent_varying_granularity(self):
        """ODD truncated extent (5) against granularity 2 pins the
        -exp-anchored offset stepping (offsets {-5,-3,-1,1,3}), and a
        bin-varying INT granularity pins the per-(frame,bin) step
        (PVModify.cpp:576-578; fixed after a round-5 review)."""
        if not os.path.isfile(os.path.join(FIXDIR, "algo_smear2.dims")):
            pytest.skip("smear2 fixtures not generated")
        _assert_planes_close(
            _input_pv().smear_time(
                lambda t, f: 0.005,
                lambda t, f: 1.0 + jnp.trunc(f / 1800.0),
                lambda t: 0.5 * (1.0 + jnp.cos(jnp.pi * t))),
            "algo_smear2")

    def test_time_extrapolate(self):
        _assert_planes_close(
            _input_pv().time_extrapolate(0.008, 0.016, 0.01),
            "algo_extrap")


@needs_r5b_fixtures
class TestMelodiaGoldens:
    """PVInformation.cpp salience/contours/prism vs compiled reference."""

    def test_salience(self):
        sal = _tonal_pv().get_salience(0, 55.0, 1760.0)
        dims = tuple(int(x) for x in open(
            os.path.join(FIXDIR, "info_salience.dims")).read().split())
        ref = np.fromfile(os.path.join(FIXDIR, "info_salience.f32"),
                          dtype="<f4").reshape(dims)
        assert (sal.num_frames, sal.num_bins) == dims
        got = np.asarray(sal.buffer).reshape(dims)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)

    def test_contours(self):
        cons = _tonal_pv().get_contours(0, 55.0, 1760.0, 30, 20.0)
        cd = np.fromfile(os.path.join(FIXDIR, "info_contours.f32"),
                         dtype="<f4")
        n_ref = int(open(os.path.join(
            FIXDIR, "info_contours.dims")).read().split()[0])
        assert len(cons) == n_ref
        i = 0
        for c in cons:
            pm, ps, sm, ss, sf, nb = cd[i:i + 6]
            assert abs(c.pitch_mean - pm) < 0.5
            assert abs(c.pitch_std_dev - ps) < 0.5
            assert abs(c.salience_mean - sm) < 1e-2 * max(1.0, abs(sm))
            assert abs(c.salience_std_dev - ss) < 1e-2 * max(1.0, abs(ss))
            assert c.start_frame == int(sf)
            assert len(c.bins) == int(nb)
            bins_ref = cd[i + 6:i + 6 + 2 * int(nb)].reshape(-1, 2)
            got = np.asarray([[b[0], b[1]] for b in c.bins], np.float32)
            np.testing.assert_allclose(got[:, 0], bins_ref[:, 0], atol=0.5)
            i += 6 + 2 * int(nb)

    def test_prism_local_time(self):
        def pf(n, t, h, f, hm):
            h = np.asarray(h, np.float32)
            return hm * (1.1 - 0.05 * h), f * h * 1.02

        _assert_planes_close(_tonal_pv().prism(pf, True),
                             "algo_prism_local")

    def test_prism_global_time(self):
        def pf(n, t, h, f, hm):
            h = np.asarray(h, np.float32)
            return hm * (0.9 + 4.0 * t), f * h

        _assert_planes_close(_tonal_pv().prism(pf, False),
                             "algo_prism_global")


# ===========================================================================
# Round-5c extension: Wavetable vs the COMPILED reference (Wavetable.cpp) —
# constructor segmentation (fixed + pitch-tracked + zero-snap), the
# FFT-interpolation table build with zero-crossing realign, the WDL-sinc
# blockwise playback with table crossfade, the edit ops, and the functional
# constructor. Fixtures: gen_algo_fixtures.cpp wt_* block.
# ===========================================================================

_WT = os.path.isfile(os.path.join(FIXDIR, "wt_src.dims"))
needs_wt_fixtures = pytest.mark.skipif(
    not _WT, reason="wavetable fixtures not generated")


def _wt_source():
    from flan_tpu import Audio
    src = np.fromfile(os.path.join(FIXDIR, "wt_src.f32"), dtype="<f4")
    return Audio.create_from_array(src[None], 8000.0)


def _wt_snr_assert(audio, name, min_db):
    got = np.asarray(audio.data, np.float64).reshape(-1)
    ref = np.fromfile(os.path.join(FIXDIR, f"{name}.f32"),
                      dtype="<f4").astype(np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = ((got - ref) ** 2).mean()
    sig = (ref ** 2).mean()
    snr = 10 * np.log10(sig / max(err, 1e-30))
    assert snr > min_db, (name, snr)


@needs_wt_fixtures
class TestWavetableGoldens:
    """Wavetable.cpp vs compiled reference. Measured agreement is
    103-107 dB on every arm (the WDL plan and segmentation are exact;
    the residual is our Kaiser-windowed sinc vs WDL's filter bank and
    f64-vs-f32 FFT rounding in the table build); 60 dB gates leave
    margin while catching any structural divergence."""

    def test_pitch_path_canary(self):
        """The exact pitch inputs the constructor sees — local
        wavelengths (window=wavelength, hop=128, cutoff=1, min=32,
        including the negative-overshoot zero quirk) + the truncated
        average."""
        a = _wt_source()
        lp = a.filter_1pole_lowpass(4000.0, 2)
        wl = np.asarray(lp.get_local_wavelengths(0, 0, -1, 128, 128,
                                                 1.0, 32))
        ref = np.fromfile(os.path.join(FIXDIR, "wt_wl.f32"), dtype="<f4")
        assert len(wl) == len(ref)
        np.testing.assert_allclose(wl, ref, atol=5e-3)
        # zero hops (the bare-2x-band negative-minimum quirk) match 1:1
        np.testing.assert_array_equal(wl == 0.0, ref == 0.0)
        avg_ref = float(open(os.path.join(
            FIXDIR, "wt_wl.dims")).read().split()[2])
        assert abs(lp.get_average_wavelength(wl, 0.2, 64.0)
                   - avg_ref) < 1e-3

    def test_fixed_frame_synthesis(self):
        from flan_tpu import PitchMode, SnapMode, Wavetable
        nw_ref = int(open(os.path.join(
            FIXDIR, "wt_meta.dims")).read().split()[0])
        wt = Wavetable(_wt_source(), SnapMode.NONE, PitchMode.NONE,
                       128, 0.3, 45)
        assert wt.get_num_waveforms(0) == nw_ref
        out = wt.synthesize(0.25, lambda t: 220.0 + 100.0 * t,
                            lambda t: 0.9 * t, True, 0.001)
        _wt_snr_assert(out, "wt_fix_synth", 60.0)

    def test_local_pitch_zero_snap_synthesis(self):
        from flan_tpu import PitchMode, SnapMode, Wavetable
        nw_ref = int(open(os.path.join(
            FIXDIR, "wt_meta.dims")).read().split()[1])
        wt = Wavetable(_wt_source(), SnapMode.ZERO, PitchMode.LOCAL,
                       128, 0.3, 256)
        assert wt.get_num_waveforms(0) == nw_ref
        out = wt.synthesize(0.25, lambda t: 160.0 + 80.0 * t,
                            lambda t: 0.5 + 0.4 * t, False, 0.001)
        _wt_snr_assert(out, "wt_loc_synth", 60.0)

    def test_edit_ops_synthesis(self):
        from flan_tpu import PitchMode, SnapMode, Wavetable
        wt = Wavetable(_wt_source(), SnapMode.ZERO, PitchMode.LOCAL,
                       128, 0.3, 256)
        wt.add_fades_in_place(16)
        wt.remove_dc_in_place()
        wt.normalize_in_place()
        out = wt.synthesize(0.125, 200.0, lambda t: 2.0 * t, True, 0.001)
        _wt_snr_assert(out, "wt_edit_synth", 60.0)

    def test_remove_jumps_synthesis(self):
        from flan_tpu import PitchMode, SnapMode, Wavetable
        wt = Wavetable(_wt_source(), SnapMode.NONE, PitchMode.NONE,
                       128, 0.3, 45)
        wt.remove_jumps_in_place(12)
        out = wt.synthesize(0.125, 300.0, lambda t: 0.8 * t, True, 0.001)
        _wt_snr_assert(out, "wt_jump_synth", 60.0)

    def test_functional_ctor_synthesis(self):
        """num_waves=1 (identical to upstream; the >1 table-fill bug is
        a PARITY.md row, not replicated). Sweeps the playback rate to
        29x — exercises the anti-alias cutoff path."""
        from flan_tpu import Wavetable
        tri = lambda p: jnp.where(p - jnp.floor(p) < 0.5,
                                  4.0 * (p - jnp.floor(p)) - 1.0,
                                  3.0 - 4.0 * (p - jnp.floor(p)))
        wt = Wavetable.from_function(tri, 1, 128)
        out = wt.synthesize(0.02, lambda t: 2000.0 + 9000.0 * t, 0.0,
                            True, 0.001)
        _wt_snr_assert(out, "wt_fn_synth", 60.0)


# ===========================================================================
# Round-5d extension: the Graph rendering layer PIXEL-GOLDEN vs the
# compiled reference (Graph.cpp + bmp/bitmap_image.hpp through the actual
# rasterizer; Color.cpp shadow-patched to the author-intended float abs —
# see tools/reference_oracle/build_algo.sh). Both scenes assert EXACT
# pixel equality: the conventions this pinned are bitmap_image's
# end-exclusive h/v segments, its Bresenham variant (final endpoint
# plotted), Pixel truncation of float32 view transforms (incl. a
# round-to-even tie at a pixel boundary the f64 math lands on the other
# side of), the height-1 row flip, draw_function's half-open
# both-endpoints-inside gate with f32-accumulated pixel stepping, and
# draw_float's whole-call abort when a digit leaves the view.
# ===========================================================================

def _load_bmp(path):
    with open(path, "rb") as fh:
        b = fh.read()
    off = int.from_bytes(b[10:14], "little")
    w = int.from_bytes(b[18:22], "little")
    h = int.from_bytes(b[22:26], "little")
    stride = (w * 3 + 3) & ~3
    img = np.zeros((h, w, 3), np.uint8)
    for y in range(h):
        row = b[off + y * stride: off + y * stride + w * 3]
        img[h - 1 - y] = np.frombuffer(row, np.uint8).reshape(w, 3)[:, ::-1]
    return img


needs_graph_fixtures = pytest.mark.skipif(
    not os.path.isfile(os.path.join(FIXDIR, "graph_composite.bmp")),
    reason="graph fixtures not generated")


@needs_graph_fixtures
class TestGraphGoldens:
    def test_composite_pixel_exact(self):
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Color, Rect
        g = Graph(120, 80)
        g.add_full_split_view_y(Rect(0, 0, 4, 2), 1)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_linear_grid(1, 0.5, 0, Color.from_hsv(0, 0, 0.7))
        g.draw_point((2.0, 1.0), 6, 0, Color.from_hsv(120, 1, 1))
        g.draw_axes(0, Color.from_hsv(200, 1, 1))
        ref = _load_bmp(os.path.join(FIXDIR, "graph_composite.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_rich_scene_pixel_exact(self):
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Color, Interval, Rect
        g = Graph(160, 120)
        g.add_full_split_view_y(Rect(-2, 0.1, 2, 100), 1)
        g.fill_image(Color.from_hsv(30, 0.2, 0.9))
        g.draw_log_grid_y(1, 10, 0, Color.from_hsv(0, 0, 0.55))
        g.draw_function(lambda x: 10.0 + 40.0 * x * x, Interval(-2, 2),
                        0, Color.from_hsv(0, 1, 0.8))
        g.draw_function([(-1.5, 80.0), (0.0, 20.0), (1.5, 60.0)],
                        plane=0, color=Color.from_hsv(260, 1, 0.9))
        g.draw_float((-1.8, 90.0), 6, 10, -3.25, 0,
                     Color.from_hsv(0, 0, 0.1))
        ref = _load_bmp(os.path.join(FIXDIR, "graph_rich.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_waveform_pixel_exact(self):
        """Buffer waveform, both modes, over a 2-plane split view —
        the 4x oversampled column-average path (Graph.cpp:68-132)."""
        from flan_tpu.graph.graph import Graph, WaveformMode
        from flan_tpu.utils.geometry import Color, Rect
        wn = 700
        t = np.arange(wn, dtype=np.float64) / wn
        wsig = (0.8 * np.sin(2.0 * np.pi * 13.0 * t)
                + 0.35 * np.sin(2.0 * np.pi * 47.0 * t + 0.9)
                ).astype(np.float32)
        g = Graph(128, 96)
        g.add_full_split_view_y(Rect(0, -1, 1, 1), 2)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_waveform(wsig, Rect(0, -1, 1, 1), 0,
                        Color.from_hsv(0, 0.8, 0.65),
                        WaveformMode.DIRECT, 4)
        g.draw_waveform(wsig, Rect(0, -1, 1, 1), 1,
                        Color.from_hsv(180, 0.8, 0.65),
                        WaveformMode.SYMMETRIC, 4)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_waveform.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_waveform_callable_pixel_exact(self):
        """The Function<float,float> overload (Graph.h:97): callable
        sampled per subsample, ALL planes over a 2-plane split,
        oversample NOT forced to 1."""
        from flan_tpu.graph.graph import ALL_PLANES, Graph, WaveformMode
        from flan_tpu.utils.geometry import Color, Rect

        def f(x):
            x = np.asarray(x, np.float32)
            return (np.float32(1.6) * x * x
                    - np.float32(0.8)).astype(np.float32)

        g = Graph(112, 80)
        g.add_full_split_view_y(Rect(0, -1, 1, 1), 2)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_waveform(f, Rect(0, -1, 1, 1), ALL_PLANES,
                        Color.from_hsv(40, 0.8, 0.65),
                        WaveformMode.DIRECT, 4)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_waveform_fn.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_spectrogram_callable_pixel_exact(self):
        """The Function<vec2,float> overload (Graph.h:156): f32-exact
        product field."""
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Color, Rect

        def f(x, y):
            return (np.asarray(x, np.float32)
                    * np.asarray(y, np.float32)).astype(np.float32)

        g = Graph(80, 56)
        g.add_full_split_view_y(Rect(0, 0, 1, 1), 1)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_spectrogram(f, Rect(0, 0, 1, 1), 0, 95.0, 4)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_spectrogram_fn.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_ticks_pixel_exact(self):
        """draw_x_ticks/draw_y_ticks (Graph.cpp:459-533): pixel-offset
        stroke extents, pow(scale_base, x) digit labels (incl. the
        off-view label abort), plane filtering, f32 tick stepping."""
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Color, Rect
        g = Graph(140, 100)
        g.add_full_split_view_y(Rect(-3, -2, 9, 6), 2)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_x_ticks(2.0, 6.0, 2.0, 8, 3, -1,
                       Color.from_hsv(0, 0, 0.9), 8.0)
        g.draw_y_ticks(2.0, -3.0, 10.0, 2, 30, 1,
                       Color.from_hsv(120, 0.7, 0.8), 0.0)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_ticks.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_audio_convert_to_graph_pixel_exact(self):
        """Audio::convert_to_graph (AudioGraph.cpp:15-53): the interval
        crops the VIEW while waveforms draw over the full-length rect,
        plus labelled timeline ticks ('1.000' everywhere:
        pow(scale_base=1, x))."""
        from flan_tpu import Audio
        from flan_tpu.utils.geometry import Interval
        sr, n, C = 4000.0, 2000, 2
        t = np.arange(n, dtype=np.float64) / sr
        sig = np.stack([
            (0.7 * np.sin(2 * np.pi * (50.0 + 30.0 * c) * t)
             + 0.2 * np.sin(2 * np.pi * 523.0 * t + 0.3 * c))
            for c in range(C)]).astype(np.float32)
        a = Audio.create_from_array(sig, sr)
        g = a.convert_to_graph(Interval(0.1, 0.35), 180, 110,
                               timeline_scale=8.0)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_audio_conv.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)

    def test_pv_convert_to_graph_pixel_exact(self):
        """PV::convert_to_graph (PVGraph.cpp:6-49): windowed-max quirk
        (end frame/bin EXCLUSIVE), continuous log2(2+freq) value field,
        get_height() one past the last bin, ticks at D.y2."""
        from flan_tpu.utils.geometry import Rect
        pv = _input_pv()
        g = pv.convert_to_graph(Rect(0.002, 300.0, 0.02, 1800.0),
                                120, 90, 6.0)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_pv_conv.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)
        g2 = pv.convert_to_graph(Rect(0, 0, -1, -1), 120, 90, 0.0)
        ref2 = _load_bmp(os.path.join(FIXDIR, "graph_pv_conv_full.bmp"))
        np.testing.assert_array_equal(g2.to_uint8(), ref2)

    def test_spectrum_graph_near_exact(self):
        """Audio::convert_to_spectrum_graph (AudioGraph.cpp:55-131).
        The pipeline runs through rfft + FFT convolve, so pixel
        equality is only near-exact (library f32 FFTs differ in ulps;
        a boundary-crossing average flips a pixel) — require >= 99%."""
        from flan_tpu import Audio
        sr, n = 4000.0, 1500
        t = np.arange(n, dtype=np.float64) / sr
        sig = (0.6 * np.sin(2 * np.pi * 220.0 * t)
               + 0.3 * np.sin(2 * np.pi * 700.0 * t)
               + 0.1 * np.sin(2 * np.pi * 1500.0 * t)
               ).astype(np.float32)[None]
        a = Audio.create_from_array(sig, sr)
        g = a.convert_to_spectrum_graph(150, 100, 64)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_spectrum_conv.bmp"))
        ours = g.to_uint8()
        same = (ours == ref).all(axis=-1).mean()
        assert same >= 0.99, f"only {same:.4f} of pixels match"

    def test_spectrogram_pixel_exact(self):
        """2x2 subsample-average spectrogram with a fractional hue —
        truncated at the int from_hsv call (Graph.cpp:157-208)."""
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Color, Rect
        sn, sm = 40, 24
        i = np.arange(sn, dtype=np.float64)[:, None]
        j = np.arange(sm, dtype=np.float64)[None, :]
        spec = (0.5 + 0.5 * np.sin(0.37 * i) * np.cos(0.61 * j)
                ).astype(np.float32)
        g = Graph(96, 64)
        g.add_full_split_view_y(Rect(0, 0, 1, 1), 1)
        g.fill_image(Color.from_hsv(0, 0, 0.04))
        g.draw_spectrogram(spec, Rect(0, 0, 1, 1), 0, 220.7, 4)
        ref = _load_bmp(os.path.join(FIXDIR, "graph_spectrogram.bmp"))
        np.testing.assert_array_equal(g.to_uint8(), ref)
