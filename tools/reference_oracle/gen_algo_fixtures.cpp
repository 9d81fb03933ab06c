// Algorithm-semantics golden generator: drives the reference's ACTUAL
// compiled algorithm layer — not replays:
//   /root/reference/src/flan/PV/PVModify.cpp   stretch / modify_frequency /
//                                              quad modify (MIMM policy) /
//                                              repitch / modify_time
//   /root/reference/src/flan/PV/PV.cpp         select / add_harmonics
//   /root/reference/src/flan/Conversions/AudioSPV.cpp  sliding-DFT fwd/inv
// compiled out-of-tree from /root/reference (never copied). FFTW is
// replaced by fft_helper_impl.cpp (same interface, radix-2); libsndfile by
// stubs/sndfile.h (never called).
//
// Every mod function used here is piecewise-rational in float32 (no
// transcendentals) so the Python side can evaluate bit-identical inputs.
//
// Usage: gen_algo_fixtures <outdir>
// Each PV dump writes <name>_mag.f32 / <name>_freq.f32 ([C,F,B] C-order)
// plus <name>.dims ("C F B" text).

#include <cmath>
#include <cstdio>
#include <cstdint>
#include <fstream>
#include <string>
#include <vector>

#include "flan/Audio/Audio.h"
#include "flan/PV/PV.h"
#include "flan/SPV/SPV.h"
#include "flan/Utility/Interpolator.h"
#include "flan/Wavetable.h"

using namespace flan;

static std::string g_dir;

static void dump_f32(const std::string& name, const float* p, size_t n) {
    std::ofstream f(g_dir + name, std::ios::binary);
    f.write(reinterpret_cast<const char*>(p), n * sizeof(float));
}

static void dump_pv(const std::string& name, const PV& pv) {
    const int C = pv.get_num_channels(), F = pv.get_num_frames(),
              B = pv.get_num_bins();
    std::vector<float> mag((size_t)C * F * B), freq((size_t)C * F * B);
    size_t i = 0;
    for (int c = 0; c < C; ++c)
        for (int f = 0; f < F; ++f)
            for (int b = 0; b < B; ++b, ++i) {
                const MF mf = pv.get_MF(c, f, b);
                mag[i] = mf.m;
                freq[i] = mf.f;
            }
    dump_f32(name + "_mag.f32", mag.data(), mag.size());
    dump_f32(name + "_freq.f32", freq.data(), freq.size());
    std::ofstream d(g_dir + name + ".dims");
    d << C << " " << F << " " << B << "\n";
}

static void dump_spv(const std::string& name, SPV& spv) {
    const int C = spv.get_num_channels(), F = spv.get_num_frames(),
              B = spv.get_num_bins();
    std::vector<float> mag((size_t)C * F * B), freq((size_t)C * F * B);
    size_t i = 0;
    for (int c = 0; c < C; ++c)
        for (int f = 0; f < F; ++f)
            for (int b = 0; b < B; ++b, ++i) {
                const MF mf = spv.get_MF(c, f, b);
                mag[i] = mf.m;
                freq[i] = mf.f;
            }
    dump_f32(name + "_mag.f32", mag.data(), mag.size());
    dump_f32(name + "_freq.f32", freq.data(), freq.size());
    std::ofstream d(g_dir + name + ".dims");
    d << C << " " << F << " " << B << "\n";
}

// Tonal input PV for the melodia-family fixtures (salience / contours /
// prism): one gliding harmonic tone (f0 ~220 Hz, +-60 cents over 96
// frames) over a -60 dB hash-noise floor. 96 frames beats prism's
// internal filter_short=60 contour gate (PVInformation.cpp:299).
// Reproducible in numpy (tests/test_algo_golden.py _tonal_pv).
static PV make_tonal_pv() {
    const int C = 1, F = 96, B = 17;
    PVBuffer::Format fmt;
    fmt.num_channels = C;
    fmt.num_frames = F;
    fmt.num_bins = B;
    fmt.sample_rate = 8000.0f;
    fmt.analysis_rate = 1000.0f;
    fmt.window_size = 32;
    PVBuffer buf(fmt);
    size_t i = 0;
    for (int f = 0; f < F; ++f) {
        const float f0 = 220.0f * std::pow(
            2.0f, 0.05f * std::sin(2.0f * 3.14159265358979323846f
                                   * (float)f / 96.0f));
        for (int b = 0; b < B; ++b, ++i) {
            const uint32_t h = (uint32_t)(i * 2654435761u);
            const float m = 0.001f * (float)(h % 1000u) / 1000.0f;
            const float fr = (float)b * 250.0f
                             + ((float)(h % 201u) / 100.0f - 1.0f) * 50.0f;
            buf.set_MF(0, f, b, MF{m, fr});
        }
        for (int hm = 1; hm <= 6; ++hm) {
            const float hf = f0 * (float)hm;
            const int b = (int)std::lround(hf / 250.0f);
            if (b < B) buf.set_MF(0, f, b, MF{1.0f / (float)hm, hf});
        }
    }
    return PV(std::move(buf));
}

// Deterministic input PV, reproducible in numpy (tests/test_algo_golden.py):
// m = (i*2654435761 % 2^32 % 1000)/1000, freq near bin center with hash
// jitter; sr=8000, dft=32 (B=17), hop=8 (analysis_rate=1000), window=32.
static PV make_input_pv(size_t seed = 0) {
    const int C = 2, F = 24, B = 17;
    PVBuffer::Format fmt;
    fmt.num_channels = C;
    fmt.num_frames = F;
    fmt.num_bins = B;
    fmt.sample_rate = 8000.0f;
    fmt.analysis_rate = 1000.0f;
    fmt.window_size = 32;
    PVBuffer buf(fmt);
    size_t i = 0;
    for (int c = 0; c < C; ++c)
        for (int f = 0; f < F; ++f)
            for (int b = 0; b < B; ++b, ++i) {
                const uint32_t h = (uint32_t)((i + seed) * 2654435761u);
                const uint32_t h2 = (uint32_t)((i + seed + 131) * 2246822519u);
                const float m = (float)(h % 1000u) / 1000.0f;
                const float jit = (float)(h2 % 2001u) / 1000.0f - 1.0f;
                const float fr = ((float)b + 0.45f * jit) * 250.0f;
                buf.set_MF(c, f, b, MF{m, fr});
            }
    return PV(std::move(buf));
}

int main(int argc, char** argv) {
    if (argc != 2) {
        std::fprintf(stderr, "usage: gen_algo_fixtures <outdir>\n");
        return 1;
    }
    g_dir = std::string(argv[1]) + "/";

    const PV in = make_input_pv();
    dump_pv("algo_in", in);

    // --- PVModify.cpp:371-385 stretch (partial integral + modify_time) --
    // NOTE (upstream bug, documented in docs/PARITY.md): a CONSTANT factor
    // crashes the reference — FunctionSample2d stores constants as one
    // slot and the in-place partial integral (PVModify.cpp:376-378)
    // doubles it (F-1)*B times, so format.num_frames overflows max_size.
    // Lambda-wrapped factors take the materialized path and work.
    dump_pv("algo_stretch2",
            in.stretch(Function<TF, float>([](TF) { return 2.0f; }),
                       Interpolator::linear()));
    dump_pv("algo_stretch_var",
            in.stretch(Function<TF, float>([](TF tf) {
                           return 1.0f + 0.5f * tf.t * 41.0f / 43.0f;
                       }),
                       Interpolator::linear()));

    // --- PVModify.cpp:259-271 modify_frequency (MIMM additive variant) --
    dump_pv("algo_modfreq_const",
            in.modify_frequency(
                Function<TF, Frequency>([](TF tf) { return tf.f * 1.3f; }),
                Interpolator::linear()));
    dump_pv("algo_modfreq_var",
            in.modify_frequency(
                Function<TF, Frequency>([](TF tf) {
                    return tf.f * (0.7f + 0.09f * tf.t * 257.0f / 4.0f);
                }),
                Interpolator::linear()));

    // --- PVModify.cpp:15-194 quad modify, MIMM endpoint policy ----------
    dump_pv("algo_modify_lin",
            in.modify(Function<TF, TF>([](TF tf) {
                          return TF{tf.t * 1.2f + 0.001f, tf.f * 0.8f + 50.0f};
                      }),
                      Interpolator::linear()));
    dump_pv("algo_modify_warp",
            in.modify(Function<TF, TF>([](TF tf) {
                          // rational warp: slight time shear by frequency,
                          // frequency compression growing with time
                          const float t2 = tf.t * (1.0f + 0.125f * tf.t) +
                                           tf.f * (0.25f / 4000.0f) * tf.t;
                          const float f2 =
                              tf.f * (0.9f - 0.25f * tf.t) + 125.0f;
                          return TF{t2, f2};
                      }),
                      Interpolator::linear()));

    // --- PVModify.cpp:273-305 repitch (bin-axis partial integral) -------
    // Lambda-wrapped for the same constant-blowup reason as stretch.
    dump_pv("algo_repitch15",
            in.repitch(Function<TF, float>([](TF) { return 1.5f; }),
                       Interpolator::linear()));

    // --- PVModify.cpp:364-369 modify_time ------------------------------
    dump_pv("algo_modtime",
            in.modify_time(
                Function<TF, Second>([](TF tf) {
                    return tf.t * (1.5f + (0.5f / 4000.0f) * tf.f);
                }),
                Interpolator::linear()));

    // --- PV.cpp:92-127 select -------------------------------------------
    dump_pv("algo_select",
            in.select(0.030f, Function<TF, TF>([](TF tf) {
                          return TF{tf.t * 0.5f + 0.002f, tf.f * 0.9f};
                      })));

    // --- PV.cpp:352-419 add_harmonics (scatter-max) ---------------------
    dump_pv("algo_harmonics",
            in.add_harmonics(
                Function<std::pair<Second, Harmonic>, float>(
                    [](std::pair<Second, Harmonic> sh) {
                        return 1.0f / (1.0f + (float)sh.second);
                    })));

    // =====================================================================
    // Round 5b: the remaining PV surface — utility/combination/generation
    // (PV.cpp), the modify extras (PVModify.cpp:387-657), and the melodia
    // family (PVInformation.cpp). Everything here is deterministic (the
    // one RNG branch, synthesize's frequency scatter, is disabled by
    // std_dev = 0).
    // =====================================================================

    // --- PV.cpp:129-203 freeze ------------------------------------------
    dump_pv("algo_freeze",
            in.freeze({0.004f, 0.012f}, {0.003f, 0.005f}));

    // --- PV.cpp:24-39 get_frame (interframe lerp) ------------------------
    dump_pv("algo_getframe", in.get_frame(0.0105f));

    // --- PV.cpp:205-270 replace/subtract_amplitudes ----------------------
    const PV in2 = make_input_pv(997);
    dump_pv("algo_replace_amp",
            in.replace_amplitudes(
                in2, Function<TF, float>([](TF tf) {
                    return 0.25f + 20.0f * tf.t;
                })));
    dump_pv("algo_subtract_amp",
            in.subtract_amplitudes(
                in2, Function<TF, float>([](TF) { return 0.5f; })));

    // --- PV.cpp:271-356 synthesize (std_dev 0 => deterministic) ----------
    dump_pv("algo_synth",
            PV::synthesize(
                0.02f,
                Function<Second, Frequency>([](Second t) {
                    return 400.0f + 3000.0f * t;
                }),
                Function<std::pair<Second, Harmonic>, Magnitude>(
                    [](std::pair<Second, Harmonic> sh) {
                        return 1.0f / (1.0f + (float)sh.second);
                    }),
                Function<Second, Frequency>([](Second) { return 120.0f; }),
                Function<TF, Frequency>([](TF) { return 0.0f; })));

    // --- PV.cpp:421-588 shape (both alignment modes) ----------------------
    dump_pv("algo_shape_t",
            in.shape(Function<MF, MF>([](MF mf) {
                         return MF{mf.m * 0.7f + 0.1f,
                                   mf.f * 0.95f + 30.0f};
                     }),
                     true));
    dump_pv("algo_shape_f",
            in.shape(Function<MF, MF>([](MF mf) {
                         return MF{mf.m * 0.7f + 0.1f,
                                   mf.f * 0.95f + 30.0f};
                     }),
                     false));

    // shape arm 3: CONSTANT shaped magnitude forces equal-magnitude
    // collisions on shared target bins — pins the sequential
    // strict-> write's first-wins (lowest source bin) frequency
    // tie-break (PV.cpp:446-448)
    dump_pv("algo_shape_tie",
            in.shape(Function<MF, MF>([](MF mf) {
                         return MF{0.5f, mf.f * 0.9f + 40.0f};
                     }),
                     true));

    // --- PV.cpp:590-600 retain/remove_n_loudest_partials ------------------
    dump_pv("algo_retain",
            in.retain_n_loudest_partials(Function<Second, Bin>(
                [](Second t) { return (Bin)(2 + t * 250.0f); })));
    dump_pv("algo_remove",
            in.remove_n_loudest_partials(Function<Second, Bin>(
                [](Second t) { return (Bin)(2 + t * 250.0f); })));

    // --- PV.cpp:602-641 resonate ------------------------------------------
    dump_pv("algo_resonate",
            in.resonate(0.04f, Function<TF, float>([](TF tf) {
                            return 0.3f + 10.0f * tf.t;
                        })));

    // --- PVModify.cpp:387-443 stretch_spline ------------------------------
    dump_pv("algo_spline",
            in.stretch_spline(Function<Second, float>(
                [](Second t) { return 2.0f + 30.0f * t; })));

    // --- PVModify.cpp:445-511 desample -------------------------------------
    dump_pv("algo_desample",
            in.desample(Function<TF, float>([](TF tf) {
                            return 0.4f + 10.0f * tf.t;
                        }),
                        Interpolator::linear()));

    // --- PVModify.cpp:513-605 smear_time -----------------------------------
    dump_pv("algo_smear",
            in.smear_time(
                Function<TF, Second>([](TF) { return 0.004f; }),
                Function<TF, int>([](TF) { return 2; }),
                Function<Second, float>([](Second t) {
                    return 0.5f * (1.0f + std::cos(
                        3.14159265358979323846f * t));
                })));

    // smear arm 2: ODD truncated extent (5) against granularity 2 pins
    // the -exp-anchored stepping (offsets {-5,-3,-1,1,3}, not
    // zero-anchored even multiples), and a bin-varying INT granularity
    // pins the per-(frame,bin) step (PVModify.cpp:576-578)
    dump_pv("algo_smear2",
            in.smear_time(
                Function<TF, Second>([](TF) { return 0.005f; }),
                Function<TF, int>([](TF tf) {
                    return 1 + (int)(tf.f / 1800.0f);
                }),
                Function<Second, float>([](Second t) {
                    return 0.5f * (1.0f + std::cos(
                        3.14159265358979323846f * t));
                })));

    // --- PVModify.cpp:607-657 time_extrapolate -----------------------------
    dump_pv("algo_extrap",
            in.time_extrapolate(0.008f, 0.016f, 0.01f,
                                Interpolator::linear()));

    // --- PV.cpp:643-731 cut_frames + join -----------------------------------
    dump_pv("algo_cutf", in.cut_frames(5, 17));
    {
        std::vector<PV> parts;
        parts.push_back(in.cut_frames(0, 10));
        parts.push_back(in.cut_frames(10, 24));
        dump_pv("algo_pvjoin", PV::join(parts));
    }

    // --- PVInformation.cpp: salience / contours / prism on the tonal PV ---
    {
        const PV tonal = make_tonal_pv();
        dump_pv("algo_tonal_in", tonal);

        PV::Salience sal = tonal.get_salience(0, 55.0f, 1760.0f);
        dump_f32("info_salience.f32", sal.buffer.data(), sal.buffer.size());
        {
            std::ofstream d(g_dir + "info_salience.dims");
            d << sal.num_frames << " " << sal.num_bins << "\n";
        }

        // contours flattened: per contour [pitch_mean, pitch_std_dev,
        // salience_mean, salience_std_dev, start_frame, num_bins,
        // bins...(x,y)]
        std::vector<PV::Contour> cons =
            tonal.get_contours(0, 55.0f, 1760.0f, 30, 20.0f);
        std::vector<float> cd;
        for (const auto& c : cons) {
            cd.push_back(c.pitch_mean);
            cd.push_back(c.pitch_std_dev);
            cd.push_back(c.salience_mean);
            cd.push_back(c.salience_std_dev);
            cd.push_back((float)c.start_frame);
            cd.push_back((float)c.bins.size());
            for (const auto& v : c.bins) {
                cd.push_back(v.x());
                cd.push_back(v.y());
            }
        }
        dump_f32("info_contours.f32", cd.data(), cd.size());
        {
            std::ofstream d(g_dir + "info_contours.dims");
            d << cons.size() << " " << cd.size() << "\n";
        }

        // prism: deterministic harmonic rewrite, both time conventions.
        // Call convention (PVInformation.cpp:368-373): h is 1-based,
        // harmonicMagnitudes is 0-indexed per h-1.
        dump_pv("algo_prism_local",
                tonal.prism(PrismFunc([](Index, Second, Harmonic h,
                                         Frequency f,
                                         const std::vector<Magnitude>& hM) {
                                return MF{hM[h - 1] * (1.1f - 0.05f * h),
                                          f * (float)h * 1.02f};
                            }),
                            true));
        dump_pv("algo_prism_global",
                tonal.prism(PrismFunc([](Index, Second t, Harmonic h,
                                         Frequency f,
                                         const std::vector<Magnitude>& hM) {
                                return MF{hM[h - 1] * (0.9f + 4.0f * t),
                                          f * (float)h};
                            }),
                            false));
    }

    // --- AudioSPV.cpp:24-106 sliding-DFT forward + :113-145 inverse -----
    {
        const int n = 512;
        const float sr = 8000.0f;
        std::vector<float> sig(n);
        for (int i = 0; i < n; ++i) {
            const double t = (double)i / sr;
            sig[i] = (float)(0.5 * std::sin(2.0 * M_PI * 440.5 * t) +
                             0.25 * std::sin(2.0 * M_PI * 1234.0 * t + 0.3));
        }
        dump_f32("sdft_sig.f32", sig.data(), sig.size());
        Audio a = Audio::create_from_buffer(std::vector<float>(sig), 1, sr);
        SPV spv = a.convert_to_SPV(16);
        dump_spv("sdft_fwd", spv);
        Audio inv = spv.convert_to_audio();
        dump_f32("sdft_inv.f32", inv.get_sample_pointer(0, 0),
                 inv.get_num_frames());
        std::ofstream d(g_dir + "sdft_inv.dims");
        d << 1 << " " << inv.get_num_frames() << "\n";
    }

    // --- AudioFilter.cpp: TPT 1/2-pole cascades,
    // shelves, multinotch, comb, Hilbert frequency shift — the 1,262-LoC
    // family previously verified only against analytic response curves.
    {
        const int n = 512, C2 = 2;
        const float sr = 8000.0f;
        std::vector<float> sig((size_t)C2 * n);
        for (int c = 0; c < C2; ++c)
            for (int i = 0; i < n; ++i) {
                const double t = (double)i / sr;
                sig[(size_t)c * n + i] = (float)(
                    0.5 * std::sin(2.0 * M_PI * (330.0 + 110.0 * c) * t) +
                    0.25 * std::sin(2.0 * M_PI * 1700.0 * t + 0.1 * c) +
                    0.1 * std::sin(2.0 * M_PI * 3333.0 * t));
            }
        dump_f32("filt_sig.f32", sig.data(), sig.size());
        {
            std::ofstream d(g_dir + "filt_sig.dims");
            d << C2 << " " << n << "\n";
        }
        const Audio a = Audio::create_from_buffer(
            std::vector<float>(sig), C2, sr);

        auto dump_audio = [&](const std::string& name, const Audio& out) {
            const int oc = out.get_num_channels(), on = out.get_num_frames();
            std::vector<float> buf((size_t)oc * on);
            for (int c = 0; c < oc; ++c)
                for (int i = 0; i < on; ++i)
                    buf[(size_t)c * on + i] = out.get_sample(c, i);
            dump_f32(name + ".f32", buf.data(), buf.size());
            std::ofstream d(g_dir + name + ".dims");
            d << oc << " " << on << "\n";
        };

        // rational-in-f32 time-varying cutoff (reproducible in numpy)
        const Function<Second, Frequency> cut_var(
            [](Second t) { return 400.0f + 20000.0f * t; });

        dump_audio("filt_1p_lp3", a.filter_1pole_lowpass(800.0f, 3));
        dump_audio("filt_1p_hp2", a.filter_1pole_highpass(500.0f, 2));
        dump_audio("filt_1p_ls", a.filter_1pole_lowshelf(500.0f, -9.0f, 1));
        dump_audio("filt_1p_hs2", a.filter_1pole_highshelf(1000.0f, 6.0f, 2));
        dump_audio("filt_1p_rep", a.filter_1pole_repeat_low(800.0f, 3));
        dump_audio("filt_2p_lp2",
                   a.filter_2pole_lowpass(1200.0f, 0.3f, 2));
        dump_audio("filt_2p_lp_var",
                   a.filter_2pole_lowpass(cut_var, 0.5f, 1));
        dump_audio("filt_2p_bp", a.filter_2pole_bandpass(900.0f, 0.5f, 1));
        dump_audio("filt_2p_hp", a.filter_2pole_highpass(600.0f, 0.4f, 1));
        dump_audio("filt_2p_notch", a.filter_2pole_notch(700.0f, 0.2f, 1));
        dump_audio("filt_2p_ls",
                   a.filter_2pole_lowshelf(500.0f, 0.5f, -6.0f, 1));
        dump_audio("filt_2p_bs",
                   a.filter_2pole_bandshelf(1000.0f, 0.4f, 5.0f, 1));
        dump_audio("filt_2p_hs",
                   a.filter_2pole_highshelf(1500.0f, 0.4f, 5.0f, 1));
        dump_audio("filt_1p_mn",
                   a.filter_1pole_multinotch(2, 800.0f, 0.3f, false, 0.5f,
                                             false));
        dump_audio("filt_2p_mn",
                   a.filter_2pole_multinotch(2, 800.0f, 0.35f, 0.3f, false,
                                             0.5f, false));
        dump_audio("filt_comb",
                   a.filter_comb(1000.0f, 0.5f, 0.5f, false));
        dump_audio("filt_comb_inv",
                   a.filter_comb(1000.0f, 0.25f, 0.5f, true));
        dump_audio("filt_shift", a.shift_frequency(123.0f, 30.0f));

        // --- Round 5 extension: volume/dynamics (AudioVolume.cpp),
        // combination (AudioCombination.cpp), temporal incl. the WDL
        // repitch (AudioTemporal.cpp), spatial (AudioSpatial.cpp),
        // synthesis (AudioSynthesis.cpp), information
        // (AudioInformation.cpp) — the remaining algorithm families on
        // citation-only or analytic-only verification.

        // volume / dynamics
        dump_audio("vol_mod", a.modify_volume(
            Function<Second, float>([](Second t) {
                return 0.25f + 8.0f * t;
            })));
        dump_audio("vol_set", a.set_volume(0.5f));
        dump_audio("vol_fade", a.fade(0.008f, 0.012f));
        dump_audio("vol_invert", a.invert_phase());
        dump_audio("vol_waveshape", a.waveshape(
            Function<std::pair<Second, Sample>, Sample>(
                [](std::pair<Second, Sample> ts) {
                    const Sample x = ts.second;
                    return x - x * x * x / 3.0f;
                }), 2));
        dump_audio("vol_compress",
                   a.compress(-12.0f, 4.0f, 0.005f, 0.02f, 6.0f, nullptr));
        dump_audio("vol_adsr",
                   a.apply_adsr_envelope(0.01f, 0.01f, 0.02f, 0.015f,
                                         0.5f, 2.0f, 0.5f, 1.0f));

        // combination
        const Audio arev = a.reverse();
        dump_audio("temp_reverse", arev);
        {
            std::vector<const Audio*> ins{&a, &arev};
            std::vector<Second> starts{0.0f, 0.01f};
            const Function<Second, Amplitude> g0(
                [](Second t) { return 1.0f - 4.0f * t; });
            const Function<Second, Amplitude> g1(0.5f);
            std::vector<const Function<Second, Amplitude>*> gains{&g0, &g1};
            dump_audio("comb_mix", Audio::mix(ins, starts, gains));
            dump_audio("comb_join", Audio::join(ins, 0.005f));
            dump_audio("comb_select", Audio::select(
                ins, Function<Second, float>([](Second t) {
                    return 16.0f * t;
                }), std::vector<Second>()));
        }
        {
            std::vector<float> irs(48);
            for (int i = 0; i < 48; ++i) {
                const uint32_t h = (uint32_t)((i + 7) * 2654435761u);
                irs[i] = ((float)(h % 2001u) / 1000.0f - 1.0f)
                         * (1.0f - (float)i / 48.0f);
            }
            const Audio ir2 = Audio::create_from_buffer(
                std::move(irs), 1, sr);
            dump_f32("comb_ir.f32", ir2.get_sample_pointer(0, 0), 48);
            dump_audio("comb_convolve", a.convolve(ir2));
        }

        // conversions: whole-buffer r8brain SRC as the oracle for the
        // polyphase windowed-sinc re-design
        dump_audio("conv_resample", a.resample(11025.0f));

        // temporal (WDL block resampling)
        dump_audio("temp_cut", a.cut(0.01f, 0.05f));
        dump_audio("temp_repitch_c",
                   a.repitch(1.5f, 0.001f, Audio::WDLResampleType::Sinc));
        dump_audio("temp_repitch_v", a.repitch(
            Function<Second, float>([](Second t) {
                return 0.75f + 8.0f * t;
            }), 0.001f, Audio::WDLResampleType::Sinc));
        dump_audio("temp_iterate", a.iterate(3));

        // spatial
        dump_audio("spat_pan_c", a.pan(0.6f));
        dump_audio("spat_pan_v", a.pan(
            Function<Second, float>([](Second t) {
                return -1.0f + 31.25f * t;
            })));
        dump_audio("spat_widen", a.widen(0.7f));
        // stereo_spatialize requires a MONO source (returns null Audio on
        // stereo input — that guard is asserted separately in the tests)
        dump_audio("spat_spatialize",
                   a.convert_to_mono().stereo_spatialize(
            Function<Second, vec2>([](Second t) {
                return vec2(1.0f - 10.0f * t, 2.0f);
            })));

        // synthesis: deterministic waveform synth (oversample + r8brain)
        dump_audio("synth_wave", Audio::synthesize_waveform(
            Function<Second, Amplitude>([](Second p) {
                return p < 0.5f ? 4.0f * p - 1.0f : 3.0f - 4.0f * p;
            }), 0.064f, 220.0f, sr, 2));

        // information: YIN wavelengths + amplitude envelope + energy
        {
            std::vector<float> wl = a.get_local_wavelengths(
                0, 0, -1, 256, 64);
            dump_f32("info_wavelengths.f32", wl.data(), wl.size());
            std::ofstream d(g_dir + "info_wavelengths.dims");
            d << 1 << " " << wl.size() << "\n";

            auto env = a.get_amplitude_envelope(0.02f);
            std::vector<float> envs(n);
            for (int i = 0; i < n; ++i)
                envs[i] = env((float)i / sr);
            dump_f32("info_amp_env.f32", envs.data(), envs.size());
            std::ofstream d2(g_dir + "info_amp_env.dims");
            d2 << 1 << " " << n << "\n";

            std::vector<float> en = a.get_total_energy();
            dump_f32("info_energy.f32", en.data(), en.size());
            std::ofstream d3(g_dir + "info_energy.dims");
            d3 << 1 << " " << en.size() << "\n";
        }
    }

    // --- Wavetable.cpp (round 5: the last family without compiled-
    // reference goldens). Driven through the public surface: waveform
    // counts + synthesize output audio. Covers the constructor
    // segmentation walk (fixed and pitch-tracked), zero-crossing
    // snapping, the FFT-interpolation table build with its
    // zero-crossing realign (Wavetable.cpp:67-132), the WDL-sinc
    // blockwise playback with table crossfade (Wavetable.cpp:266-334),
    // the edit ops, and the functional constructor (num_waves=1; the
    // table-fill indexing bug for num_waves>1, Wavetable.cpp:246-247,
    // is documented in docs/PARITY.md rather than replicated).
    {
        const float sr = 8000.0f;
        const int n = 8000;
        std::vector<float> sig(n);
        for (int i = 0; i < n; ++i) {
            const double t = (double)i / sr;
            const double ph = 2.0 * M_PI * (170.0 * t + 10.0 * t * t);
            sig[i] = (float)(0.6 * std::sin(ph)
                             + 0.25 * std::sin(2.0 * ph + 0.7)
                             + 0.1 * std::sin(3.0 * ph + 1.9));
        }
        dump_f32("wt_src.f32", sig.data(), sig.size());
        {
            std::ofstream d(g_dir + "wt_src.dims");
            d << 1 << " " << n << "\n";
        }
        const Audio a = Audio::create_from_buffer(
            std::vector<float>(sig), 1, sr);

        auto dump_audio = [&](const std::string& name, const Audio& out) {
            const int oc = out.get_num_channels(), on = out.get_num_frames();
            std::vector<float> buf((size_t)oc * on);
            for (int c = 0; c < oc; ++c)
                for (int i = 0; i < on; ++i)
                    buf[(size_t)c * on + i] = out.get_sample(c, i);
            dump_f32(name + ".f32", buf.data(), buf.size());
            std::ofstream d(g_dir + name + ".dims");
            d << oc << " " << on << "\n";
        };

        // diagnosis fixture: the exact pitch inputs the constructor sees
        // (lowpassed source, window=wavelength, hop=128, cutoff=1, min=32)
        const Audio lp = a.filter_1pole_lowpass(4000, 2);
        std::vector<float> wl = lp.get_local_wavelengths(
            0, 0, -1, 128, 128, 1, 32);
        dump_f32("wt_wl.f32", wl.data(), wl.size());
        const float avg = lp.get_average_wavelength(wl, .2, 64);
        {
            std::ofstream d(g_dir + "wt_wl.dims");
            d << 1 << " " << wl.size() << " " << avg << "\n";
        }

        // arm 1: fixed frame size, no snapping — isolates the FFT table
        // build + playback from the pitch tracker
        Wavetable wt_fix(a, Wavetable::SnapMode::None,
                         Wavetable::PitchMode::None, 128, .3f, 45);
        dump_audio("wt_fix_synth", wt_fix.synthesize(
            0.25f,
            Function<Second, Frequency>(
                [](Second t) { return 220.0f + 100.0f * t; }),
            Function<Second, float>([](Second t) { return 0.9f * t; }),
            true, 0.001f));

        // arm 2: zero-snap + local pitch — the full constructor path;
        // smooth=false reads the left table entry only
        Wavetable wt_loc(a, Wavetable::SnapMode::Zero,
                         Wavetable::PitchMode::Local, 128, .3f, 256);
        dump_audio("wt_loc_synth", wt_loc.synthesize(
            0.25f,
            Function<Second, Frequency>(
                [](Second t) { return 160.0f + 80.0f * t; }),
            Function<Second, float>(
                [](Second t) { return 0.5f + 0.4f * t; }),
            false, 0.001f));
        {
            std::ofstream d(g_dir + "wt_meta.dims");
            d << wt_fix.get_num_waveforms(0) << " "
              << wt_loc.get_num_waveforms(0) << "\n";
        }

        // arm 3: edit ops on the pitch-tracked table, then resynthesize
        wt_loc.add_fades_in_place(16);
        wt_loc.remove_dc_in_place();
        wt_loc.normalize_in_place();
        dump_audio("wt_edit_synth", wt_loc.synthesize(
            0.125f,
            Function<Second, Frequency>([](Second) { return 200.0f; }),
            Function<Second, float>([](Second t) { return 2.0f * t; }),
            true, 0.001f));

        // arm 3b: remove_jumps on the fixed table
        wt_fix.remove_jumps_in_place(12);
        dump_audio("wt_jump_synth", wt_fix.synthesize(
            0.125f,
            Function<Second, Frequency>([](Second) { return 300.0f; }),
            Function<Second, float>([](Second t) { return 0.8f * t; }),
            true, 0.001f));

        // arm 4: functional constructor (table sample rate 48000)
        const Wavetable wt_fn(
            Function<Second, Amplitude>([](Second p) {
                const float x = p - std::floor(p);
                return x < 0.5f ? 4.0f * x - 1.0f : 3.0f - 4.0f * x;
            }),
            1, 128);
        dump_audio("wt_fn_synth", wt_fn.synthesize(
            0.02f,
            Function<Second, Frequency>(
                [](Second t) { return 2000.0f + 9000.0f * t; }),
            Function<Second, float>([](Second) { return 0.0f; }),
            true, 0.001f));
    }

    // --- Graph.cpp (round 5: pixel-golden the rendering layer) -----------
    // Two BMPs through the reference's actual rasterizer (bitmap_image's
    // exclusive-end segments, Pixel-trunc view mapping, height-1 flip).
    // The oracle's Color.cpp is shadow-patched to float abs (gcc resolves
    // the C int abs the author's MSVC would not; see build_algo.sh).
    {
        Graph g(120, 80);
        g.add_full_split_view_y(Rect(0, 0, 4, 2), 1);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_linear_grid(1, 0.5f, 0, Color::from_hsv(0, 0, 0.7f));
        g.draw_point(vec2(2.0f, 1.0f), 6, 0, Color::from_hsv(120, 1, 1));
        g.draw_axes(0, Color::from_hsv(200, 1, 1));
        g.save_image(g_dir + "graph_composite.bmp");
    }
    {
        Graph g(160, 120);
        g.add_full_split_view_y(Rect(-2, 0.1f, 2, 100), 1);
        g.fill_image(Color::from_hsv(30, 0.2f, 0.9f));
        g.draw_log_grid_y(1, 10, 0, Color::from_hsv(0, 0, 0.55f));
        g.draw_function(Function<float, float>(
                            [](float x) { return 10.0f + 40.0f * x * x; }),
                        Interval(-2, 2), 0, Color::from_hsv(0, 1, 0.8f));
        g.draw_function(std::vector<vec2>{{-1.5f, 80.0f}, {0.0f, 20.0f},
                                          {1.5f, 60.0f}},
                        0, Color::from_hsv(260, 1, 0.9f));
        g.draw_float(vec2(-1.8f, 90.0f), 6, 10, -3.25f, 0,
                     Color::from_hsv(0, 0, 0.1f));
        g.save_image(g_dir + "graph_rich.bmp");
    }
    {
        // waveforms: the buffer overload's 4x oversampled column
        // averages (Graph.cpp:68-132), both modes, over a 2-plane split
        const int wn = 700;                // > width: oversample stays 4
        std::vector<float> wsig(wn);
        for (int i = 0; i < wn; ++i) {
            const double t = (double)i / wn;
            wsig[i] = (float)(0.8 * std::sin(2.0 * M_PI * 13.0 * t)
                              + 0.35 * std::sin(2.0 * M_PI * 47.0 * t
                                                + 0.9));
        }
        Graph g(128, 96);
        g.add_full_split_view_y(Rect(0, -1, 1, 1), 2);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_waveform(wsig.data(), wn, Rect(0, -1, 1, 1), 0,
                        Color::from_hsv(0, 0.8f, 0.65f),
                        Graph::WaveformMode::Direct, 4);
        g.draw_waveform(wsig.data(), wn, Rect(0, -1, 1, 1), 1,
                        Color::from_hsv(180, 0.8f, 0.65f),
                        Graph::WaveformMode::Symmetric, 4);
        g.save_image(g_dir + "graph_waveform.bmp");
    }
    {
        // the Function<float,float> waveform overload (Graph.h:97,
        // Graph.cpp:69-120): f32-exact polynomial, ALL planes over a
        // 2-plane split, oversample NOT forced to 1
        Graph g(112, 80);
        g.add_full_split_view_y(Rect(0, -1, 1, 1), 2);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_waveform([](float x) { return 1.6f * x * x - 0.8f; },
                        Rect(0, -1, 1, 1), Graph::Plane::All,
                        Color::from_hsv(40, 0.8f, 0.65f),
                        Graph::WaveformMode::Direct, 4);
        g.save_image(g_dir + "graph_waveform_fn.bmp");
    }
    {
        // the Function<vec2,float> spectrogram overload (Graph.h:156,
        // Graph.cpp:157-194): f32-exact product field
        Graph g(80, 56);
        g.add_full_split_view_y(Rect(0, 0, 1, 1), 1);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_spectrogram([](vec2 xy) { return xy.x() * xy.y(); },
                           Rect(0, 0, 1, 1), 0, 95.0f, 4);
        g.save_image(g_dir + "graph_spectrogram_fn.bmp");
    }
    {
        // spectrogram: 2x2 subsample average + HSV magnitude colors
        // with a FRACTIONAL hue (truncated at the int from_hsv call)
        const int sn = 40, sm = 24;
        std::vector<float> spec((size_t)sn * sm);
        for (int i = 0; i < sn; ++i)
            for (int j = 0; j < sm; ++j)
                spec[(size_t)i * sm + j] = (float)(
                    0.5 + 0.5 * std::sin(0.37 * i) * std::cos(0.61 * j));
        Graph g(96, 64);
        g.add_full_split_view_y(Rect(0, 0, 1, 1), 1);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_spectrogram(spec.data(), sn, sm, Rect(0, 0, 1, 1), 0,
                           220.7f, 4);
        g.save_image(g_dir + "graph_spectrogram.bmp");
    }

    {
        // tick strokes + pow(scale_base, x) digit labels over a 2-plane
        // split (Graph.cpp:459-533): x ticks on ALL planes with labels
        // (incl. an off-view label abort), y ticks plane-filtered
        Graph g(140, 100);
        g.add_full_split_view_y(Rect(-3, -2, 9, 6), 2);
        g.fill_image(Color::from_hsv(0, 0, 0.04f));
        g.draw_x_ticks(2.0f, 6.0f, 2.0f, 8, 3, -1,
                       Color::from_hsv(0, 0, 0.9f), 8.0f);
        g.draw_y_ticks(2.0f, -3.0f, 10.0f, 2, 30, 1,
                       Color::from_hsv(120, 0.7f, 0.8f), 0.0f);
        g.save_image(g_dir + "graph_ticks.bmp");
    }
    {
        // Audio::convert_to_graph (AudioGraph.cpp:15-53): sub-interval
        // view over full-length waveforms + labelled timeline ticks
        const float sr = 4000.0f;
        const int n = 2000, C = 2;
        std::vector<float> sig((size_t)C * n);
        for (int c = 0; c < C; ++c)
            for (int i = 0; i < n; ++i) {
                const double t = (double)i / sr;
                sig[(size_t)c * n + i] = (float)(
                    0.7 * std::sin(2.0 * M_PI * (50.0 + 30.0 * c) * t)
                    + 0.2 * std::sin(2.0 * M_PI * 523.0 * t + 0.3 * c));
            }
        const Audio a = Audio::create_from_buffer(
            std::vector<float>(sig), C, sr);
        Graph g = a.convert_to_graph(Interval(0.1f, 0.35f), 180, 110,
                                     Graph::WaveformMode::Symmetric,
                                     8.0f);
        g.save_image(g_dir + "graph_audio_conv.bmp");
    }
    {
        // PV::convert_to_graph (PVGraph.cpp:6-49): windowed max quirk,
        // continuous log2(2+freq) value field, labelled ticks at D.y2
        PV pv = make_input_pv();
        Graph g = pv.convert_to_graph(Rect(0.002f, 300.0f, 0.02f,
                                           1800.0f), 120, 90, 6.0f);
        g.save_image(g_dir + "graph_pv_conv.bmp");
        Graph g2 = pv.convert_to_graph(Rect(0, 0, -1, -1), 120, 90, 0.0f);
        g2.save_image(g_dir + "graph_pv_conv_full.bmp");
    }
    {
        // Audio::convert_to_spectrum_graph (AudioGraph.cpp:55-131):
        // near-exact oracle (FFT/convolve are f32-library-dependent)
        const float sr = 4000.0f;
        const int n = 1500;
        std::vector<float> sig(n);
        for (int i = 0; i < n; ++i) {
            const double t = (double)i / sr;
            sig[i] = (float)(0.6 * std::sin(2.0 * M_PI * 220.0 * t)
                             + 0.3 * std::sin(2.0 * M_PI * 700.0 * t)
                             + 0.1 * std::sin(2.0 * M_PI * 1500.0 * t));
        }
        const Audio a = Audio::create_from_buffer(
            std::vector<float>(sig), 1, sr);
        Graph g = a.convert_to_spectrum_graph(150, 100, 64);
        g.save_image(g_dir + "graph_spectrum_conv.bmp");
    }

    std::printf("algo fixtures written to %s\n", g_dir.c_str());
    return 0;
}
