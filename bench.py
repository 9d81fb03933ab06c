"""Benchmarks for the BASELINE.md configurations, on an NVIDIA GPU.

Default: runs the headline path - fused PV 2x time-stretch of 10-minute
stereo 48 kHz audio - and prints ONE JSON line {"metric", "value", "unit",
"device", ...} to stdout, with the numerics gates of
flan_tpu/utils/gates.py run in the same process.

`python bench.py --all` also times the other configurations (round-trip,
resample+filter chain, convolution reverb + texture + granulate, spectral
morph, repitch, SPV, SQPV, 16-clip batch) and prints one JSON line per
configuration to stderr. Each configuration runs in its own subprocess,
one at a time: a JAX process reserves most of the card's memory when it
starts, so the parent never initialises JAX and no two children overlap.

`python bench.py --one NAME` runs one configuration in this process.
A run that finds no GPU fails; exit status is non-zero if any
configuration failed.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks, keyed by jax's device_kind. Source: NVIDIA H100 SXM
# data sheet, dense rates without sparsity, at the 700 W power limit.
# A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,      # CUDA cores, outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind: str) -> dict:
    """Peak rates of the device kind; ValueError for an unlisted one."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no peak rates for device kind {kind!r}; add its "
                         "data-sheet row to bench.PEAKS") from None


def device_fields() -> dict:
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _best_time(fn, reps=3):
    """Best wall time of fn() over reps, each waited on with
    block_until_ready. The warmup call compiles, and its output must be
    finite: a benchmark of a broken path is not a measurement."""
    import jax
    import jax.numpy as jnp
    out = jax.block_until_ready(fn())
    for leaf in jax.tree_util.tree_leaves(out):
        if not bool(jnp.isfinite(leaf).all()):
            raise FloatingPointError("non-finite output in warmup call")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _stereo_test_signal(seconds, sr=48000.0, seed=0):
    import jax.numpy as jnp
    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)
    return jnp.asarray(x)


def _cost_analysis(compiled):
    """XLA's own (flops, bytes accessed) of a compiled program; None for
    a count XLA does not report."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    bytes_hbm = float(ca.get("bytes accessed", 0.0))
    return (flops if flops > 0 else None,
            bytes_hbm if bytes_hbm > 0 else None)


def _stretch_flops_model(n, factor, hop=128, dft=4096, channels=2):
    """Analytic FLOP model of the PV stretch: XLA's cost_analysis counts
    zero flops for the FFT custom call, so the compiled-program number
    alone undercounts. Real FFTs ~ 2.5 * N * log2(N) flops each; forward
    per input hop, inverse per output hop; remap/phase work is O(bins)
    per hop (folded into a 20% fudge)."""
    import math as _m
    hops_in = n / hop
    hops_out = hops_in * factor
    per_fft = 2.5 * dft * _m.log2(dft)
    return 1.2 * channels * (hops_in + hops_out) * per_fft


def _roofline_fields(compiled, best_s, flops_model):
    """Achieved rates of a timed program against the device's peaks: the
    FFT-dominated PV work runs in float32 on the CUDA cores, so the flop
    share is of the f32 peak; bytes are XLA's own count."""
    import jax
    peaks = device_peaks(jax.devices()[0].device_kind)
    _, bytes_hbm = _cost_analysis(compiled)
    out = {"gflops_model": round(flops_model / 1e9, 1),
           "f32_peak_pct": round(
               flops_model / best_s / peaks["f32_flops"] * 100, 3)}
    if bytes_hbm:
        out["hbm_gb_per_s"] = round(bytes_hbm / best_s / 1e9, 1)
        out["hbm_peak_pct"] = round(
            bytes_hbm / best_s / peaks["hbm_bytes_per_s"] * 100, 3)
    return out


def _numerics_fields():
    """Numerics gates run in the same process as the headline timing, so
    the recorded number carries its fidelity evidence (a site that drops
    to TF32 stays green on the CPU suite and collapses a gate here)."""
    from flan_tpu.utils.gates import run_gates
    res = run_gates(("fft", "resample", "stretch"))
    return {"snr_db": {k: round(v, 1) for k, (v, _) in res.items()},
            "numerics_ok": all(v >= t for v, t in res.values())}


def bench_headline():
    """Config 2 / north star: PV 2x stretch, 10-min stereo 48 kHz."""
    import jax
    from flan_tpu.pipelines import pv_stretch_pipeline
    seconds = 600.0
    x = _stereo_test_signal(seconds)

    fj = jax.jit(lambda v: pv_stretch_pipeline(
        v, 2.0, window_size=2048, hop=128, dft_size=4096,
        sample_rate=48000.0))
    compiled = fj.lower(x).compile()
    best = _best_time(lambda: compiled(x))
    out = {
        "metric": "pv_stretch_x_realtime_10min_stereo_48k",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
        "device": device_fields(),
    }
    out.update(_roofline_fields(
        compiled, best, _stretch_flops_model(x.shape[-1], 2.0)))
    out.update(_numerics_fields())
    return out


def bench_batch():
    """16 one-minute stereo clips stretched as a pipelined sequence of
    fold-2 groups ([2 clips, 2ch, n] -> [4, n]; every pipeline op
    batches over channels natively): 8 async dispatches of ONE compiled
    program. The fold was tuned on the previous accelerator; re-sweeping
    it here is an open question (tools/ab_batch.py)."""
    import jax
    import jax.numpy as jnp
    from flan_tpu.pipelines import pv_stretch_pipeline
    clip_seconds, nclips, fold = 60.0, 16, 2
    base = _stereo_test_signal(clip_seconds)
    rng = np.random.default_rng(3)
    clips = (np.asarray(base)[None]
             * rng.uniform(0.5, 1.0, (nclips, 1, 1)).astype(np.float32))
    n = clips.shape[-1]
    groups = jax.block_until_ready(
        [jnp.asarray(clips[g * fold:(g + 1) * fold].reshape(fold * 2, n))
         for g in range(nclips // fold)])

    fj = jax.jit(lambda v: pv_stretch_pipeline(
        v, 2.0, window_size=2048, hop=128, dft_size=4096,
        sample_rate=48000.0))
    compiled = fj.lower(groups[0]).compile()
    # dispatches of one executable run in order on the device; the
    # timing waits on all of them
    best = _best_time(lambda: [compiled(g) for g in groups], reps=2)
    total = clip_seconds * nclips
    out = {
        "metric": "pv_stretch_batch16_x_realtime_60s_stereo",
        "value": round(total / best, 2),
        "unit": "x_realtime_aggregate",
    }
    out.update(_roofline_fields(
        compiled, best / len(groups),
        _stretch_flops_model(n, 2.0, channels=fold * 2)))
    return out


def bench_roundtrip():
    """Config 1: Audio -> PV -> Audio identity, mono 44.1k, 1024-pt FFT,
    4x overlap."""
    from flan_tpu.ops import stft
    seconds = 60.0
    sr = 44100.0
    x = _stereo_test_signal(seconds, sr)[0:1]

    def run():
        mag, freq = stft.pv_forward(x, window_size=1024, hop=256,
                                    dft_size=1024, sample_rate=sr)
        return stft.pv_inverse(mag, freq, window_size=1024, hop=256,
                               sample_rate=sr)

    best = _best_time(run)
    frames = x.shape[-1] / 256  # PV frames processed (fwd+inv)
    return {
        "metric": "stft_roundtrip_x_realtime_60s_mono_44k1",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
        "mframes_per_sec": round(2 * frames / best / 1e6, 3),
    }


def bench_resample_filter():
    """Config 3: 44.1k -> 48k resample + filter bank."""
    from flan_tpu import Audio
    seconds = 60.0
    x = _stereo_test_signal(seconds, 44100.0)
    a = Audio(data=x, sample_rate=44100.0)

    def run():
        return (a.resample(48000.0)
                .filter_2pole_lowpass(8000.0, 0.5, 2)
                .filter_2pole_highpass(60.0, 0.5, 2)
                .filter_1pole_lowshelf(200.0, 3.0)).data

    best = _best_time(run)
    return {
        "metric": "resample_filterbank_x_realtime_60s_stereo",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
    }


def bench_convolve_texture():
    """Config 4: FFT convolution reverb + granular texture."""
    from flan_tpu import Audio
    seconds = 30.0
    x = _stereo_test_signal(seconds)
    a = Audio(data=x, sample_rate=48000.0)
    rng = np.random.default_rng(1)
    ir = Audio.create_from_array(
        (rng.standard_normal(48000).astype(np.float32)
         * np.exp(-np.arange(48000) / 8000.0))[None], 48000.0)

    best = _best_time(lambda: a.convolve(ir).data)
    best_tex = _best_time(
        lambda: a.cut(0.0, 0.25).texture(seconds, 20.0, 0.2, seed=0).data,
        reps=2)
    # dense batched path: one static gather + envelopes + block mixer
    best_gran = _best_time(
        lambda: a.granulate(seconds, 20.0, 0.1, lambda t: 0.5 * t, 0.1,
                            0.01, seed=0).data, reps=2)
    return {
        "metric": "convolve_reverb_x_realtime_30s_stereo",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
        "texture_x_realtime": round(seconds / best_tex, 2),
        "granulate_x_realtime": round(seconds / best_gran, 2),
    }


def bench_spv():
    """Streaming sliding-DFT phase vocoder round trip, 30 s mono 48 kHz.

    The naive (materialized) form needs ~23 GB of complex intermediates at
    this size; the chunked-scan form (flan_tpu/spv/spv.py) keeps transient
    device memory at O(chunk x bins)."""
    from flan_tpu import Audio
    seconds = 30.0
    x = _stereo_test_signal(seconds)[0:1]
    a = Audio(data=x, sample_rate=48000.0)
    best = _best_time(
        lambda: a.convert_to_SPV(512).convert_to_audio().data, reps=2)
    return {
        "metric": "spv_roundtrip_x_realtime_30s_mono_48k",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
    }


def bench_sqpv():
    """Activated sliding constant-Q transform round trip, 10 s mono 48 kHz
    (dormant in the reference: AudioSQPV.cpp commented out; activated in
    flan_tpu/sqpv/transform.py as chunked modulated prefix sums)."""
    from flan_tpu import Audio
    seconds = 10.0
    x = _stereo_test_signal(seconds)[0:1]
    a = Audio(data=x, sample_rate=48000.0)
    best = _best_time(
        lambda: a.convert_to_SQPV((16.0, 24000.0), 24.0)
        .convert_to_audio().data, reps=2)
    return {
        "metric": "sqpv_roundtrip_x_realtime_10s_mono_48k",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
    }


def bench_repitch():
    """Streaming fused PV repitch (constant factor fast path: the inverse
    bin map is host-precomputed)."""
    from flan_tpu.pipelines import pv_repitch_pipeline
    seconds = 60.0
    x = _stereo_test_signal(seconds)
    best = _best_time(
        lambda: pv_repitch_pipeline(x, 1.5, sample_rate=48000.0), reps=2)
    return {
        "metric": "pv_repitch_fused_x_realtime_60s_stereo",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
    }


def bench_morph():
    """Config 5: spectral morph between two PVs with lambda controls."""
    import jax
    import jax.numpy as jnp
    from flan_tpu import Audio
    from flan_tpu.pipelines import pv_morph_pipeline
    seconds = 60.0
    a = Audio(data=_stereo_test_signal(seconds, seed=0),
              sample_rate=48000.0)
    b = Audio(data=_stereo_test_signal(seconds, seed=1),
              sample_rate=48000.0)
    pv_a, pv_b = jax.block_until_ready(
        (a.convert_to_PV(), b.convert_to_PV()))

    best = _best_time(lambda: pv_a.replace_amplitudes(
        pv_b, lambda t, f: jnp.clip(t / seconds, 0.0, 1.0))
        .convert_to_audio().data, reps=2)

    # the fused streaming path (audio->audio, O(chunk) memory). ONE
    # amount-function object: the chunk op is memoized on it, and a
    # fresh lambda per call would retrace the fused scan every repetition
    amt_fused = lambda t, f: jnp.clip(t / seconds, 0.0, 1.0)  # noqa: E731
    best_fused = _best_time(
        lambda: pv_morph_pipeline(a.data, b.data, amt_fused), reps=2)
    return {
        "metric": "spectral_morph_x_realtime_60s_stereo",
        "value": round(seconds / best, 2),
        "unit": "x_realtime",
        "fused_x_realtime": round(seconds / best_fused, 2),
    }


OTHER_CONFIGS = ("bench_roundtrip", "bench_resample_filter",
                 "bench_convolve_texture", "bench_morph", "bench_repitch",
                 "bench_spv", "bench_sqpv", "bench_batch")


def run_one(name: str) -> dict:
    """Run one configuration in this process, on the GPU only."""
    from flan_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {platform!r}")
    return globals()[name]()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--one" in argv:
        print(json.dumps(run_one(argv[argv.index("--one") + 1])))
        return 0
    names = ["bench_headline"]
    if "--all" in argv:
        names = list(OTHER_CONFIGS) + names
    failed = 0
    for name in names:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", name],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            failed += 1
            line = json.dumps({"metric": name, "error": r.stderr[-400:]})
        else:
            line = lines[-1]
        print(line, file=sys.stdout if name == "bench_headline"
              else sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
