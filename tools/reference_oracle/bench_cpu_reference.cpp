// CPU baseline for BASELINE.json's second north-star clause ("≥20x faster
// than single-thread Flan CPU"): times the reference's REAL compiled
// pipeline — Audio::convert_to_PV (AudioPV.cpp:24-84), PV::stretch
// (PVModify.cpp:371-385), PV::convert_to_audio (AudioPV.cpp:86-139) —
// single-threaded (build_cpu_bench.sh forces every FLAN execution policy
// to std::execution::seq), on the same 10-minute stereo 48 kHz headline
// config bench.py measures on the GPU.
//
// FFTW is not installed on this box; fft_helper_impl.cpp (scalar radix-2,
// double twiddles) stands in. BASELINE.md documents the honesty
// adjustment: a tuned FFTWF is typically 2-4x faster than this form, so
// the FFT-dominated conversion phases are also reported separately and
// the published ratio credits the reference with a 4x faster FFT.
//
// Usage: bench_cpu_reference [seconds=600] [channels=2]
// Prints one JSON line with per-phase wall seconds and x-realtime.

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>

#include "flan/Audio/Audio.h"
#include "flan/PV/PV.h"

using namespace flan;

static double now_s() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

int main(int argc, char** argv) {
    const double seconds = argc > 1 ? std::atof(argv[1]) : 600.0;
    const int channels = argc > 2 ? std::atoi(argv[2]) : 2;
    const double sr = 48000.0;

    // Deterministic broadband test signal (content does not affect the
    // timing of any phase; every loop below is data-independent).
    Audio::Format fmt;
    fmt.num_channels = channels;
    fmt.num_frames = (Frame)(seconds * sr);
    fmt.sample_rate = (FrameRate)sr;
    Audio a(fmt);
    for (Channel c = 0; c < channels; ++c)
        for (Frame f = 0; f < a.get_num_frames(); ++f) {
            const float t = (float)f / (float)sr;
            a.get_sample(c, f) =
                0.30f * std::sin(6.2831853f * 220.0f * t + c) +
                0.20f * std::sin(6.2831853f * 773.0f * t) +
                0.10f * std::sin(6.2831853f * 2917.0f * t);
        }

    const double t0 = now_s();
    const PV pv = a.convert_to_PV();  // defaults: 2048 / 128 / 4096
    const double t1 = now_s();
    // NOTE: a lambda, not the literal 2.0f — a constant Function takes
    // FunctionSample's constant path, whose writable at() aliases one
    // shared cell; stretch's partial-integral loop (PVModify.cpp:377-380)
    // then doubles it to inf and the output is null. Reference behavior,
    // verified on the compiled binary. The lambda takes the sampled-grid
    // path, which is also the realistic timing path.
    const PV stretched = pv.stretch([](TF) { return 2.0f; });
    const double t2 = now_s();
    const Audio out = stretched.convert_to_audio();
    const double t3 = now_s();

    const double total = t3 - t0;
    std::printf(
        "{\"metric\": \"reference_cpu_stretch_x_realtime\", "
        "\"audio_seconds\": %.1f, \"channels\": %d, "
        "\"convert_to_pv_s\": %.3f, \"stretch_s\": %.3f, "
        "\"convert_to_audio_s\": %.3f, \"total_s\": %.3f, "
        "\"x_realtime\": %.3f, "
        "\"out_frames\": %d, \"pv_frames\": %d}\n",
        seconds, channels, t1 - t0, t2 - t1, t3 - t2, total,
        seconds / total, (int)out.get_num_frames(),
        (int)pv.get_num_frames());
    return 0;
}
