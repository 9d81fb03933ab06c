#!/usr/bin/env python3
"""Bring-up check of flan_tpu on an NVIDIA GPU, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the multi-card phase only

One card: the numerics gates (flan_tpu/utils/gates.py) at their
thresholds; the headline deployment, a 2x PV time-stretch of a 10-minute
stereo 48 kHz WAV through the CLI (`python -m flan_tpu stretch`), timed
as x realtime; the README's materializing API example at 60 s, checked
against the streamed pipeline; the 10-minute materializing path with its
peak device memory; card-versus-CPU comparisons of every translated path
on short excerpts; and one run of each other bench.py configuration at
its own size.

Four cards (--multi): a 120-minute stereo stretch sharded over time
against the single-card streamed pipeline, the CLI's data-parallel batch
of 8 one-minute clips against per-clip single-card runs, and the
sharded convolution and IIR recurrence against their single-card forms.

Every phase prints its seconds and each comparison its value beside its
tolerance. Any failed phase makes the exit status non-zero and the
result line is not printed. The last line on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
The script refuses to run on anything but a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SR = 48000.0
# Durations in seconds: the headline master, the README example, the
# card-vs-CPU excerpts, and the four-card master and batch clips.
HEADLINE_S = 600.0
API_S = 60.0
EXCERPT_S = 10.0
SHORT_S = 2.0
MULTI_LONG_S = 7200.0
MULTI_CLIP_S = 60.0
MULTI_CLIPS = 8


def stereo_signal(seconds: float, seed: int = 0) -> np.ndarray:
    """[2, n] float32: 220/330 Hz sines plus white noise. Phase from the
    integer sample index mod SR, so it stays exact for long clips."""
    n = int(seconds * SR)
    i = np.arange(n, dtype=np.int64) % int(SR)
    rng = np.random.default_rng(seed)
    x = np.stack([0.4 * np.sin(2 * np.pi * ((i * 220) % int(SR)) / SR),
                  0.4 * np.sin(2 * np.pi * ((i * 330) % int(SR)) / SR)])
    x += 0.1 * rng.standard_normal((2, n))
    return x.astype(np.float32)


def spectral_snr_db(ref, got, frame: int = 4096) -> float:
    """SNR of the magnitude spectra of [C, n] signals (hann frames, no
    overlap), computed where the arrays live. Blind to a slow phase
    drift of each partial, which a phase vocoder's float32 phase
    accumulator leaves behind and which the ear does not hear."""
    import jax.numpy as jnp
    ref, got = jnp.asarray(ref), jnp.asarray(got)
    n = ref.shape[-1] // frame * frame
    w = jnp.hanning(frame).astype(jnp.float32)

    def mags(v):
        v = v[..., :n].reshape(v.shape[0], -1, frame) * w
        return jnp.abs(jnp.fft.rfft(v, axis=-1))
    r, g = mags(ref), mags(got)
    return float(10.0 * jnp.log10(jnp.sum(r * r)
                                  / jnp.maximum(jnp.sum((r - g) ** 2),
                                                1e-30)))


def dominant_hz(x: np.ndarray) -> float:
    seg = x[len(x) // 2: len(x) // 2 + (1 << 17)]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float(np.argmax(spec) * SR / len(seg))


# Tolerances, each with its reason.
WHY_SAME_PROGRAM = ("same compiled arithmetic on the same bits; only "
                    "fusion order may differ")
WHY_FUSED = ("the two paths batch the same float32 transforms "
             "differently; 60 dB is 1e-3 of the signal")
WHY_FFT = ("float32 on both backends; cuFFT and the CPU FFT round "
           "differently, ~1e-7 relative, so 100 dB leaves a 30 dB margin")
WHY_CYCLES = ("hop increments in cycles where the bin is within 40 dB of "
              "the peak; float32 rounding of the frequency is ~5e-6 cycles")
WHY_DRIFT = ("a steady partial's frequency rounds to float32 alike at "
             "every hop, so a last-bit gap between the two forward FFTs "
             "is summed by the phase accumulator and the phase drifts "
             "linearly (on an H100, 1.7e-3 cycles rms after 7500 hops: "
             "~45 dB over 10 s); a TF32 prefix sum reads 25 dB waveform, "
             "31 dB magnitude spectrum")
WHY_ROUND_TRIP = ("the forward planes' gap above passes through the "
                  "inverse's phase accumulator, which sums it along the "
                  "clip; bounds 10 dB below an H100's readings")
WHY_SHARDED = ("the same float32 program on the same kind of card; the "
               "shards' exchange (all_gather of cycle prefixes, ppermute "
               "of overlap-add tails) only reassociates float32 sums, "
               "~1e-7 relative")
WHY_TF32 = ("the SPV prefix sums run at precision HIGH, TF32 on the card "
            "(10-bit mantissa, ~5e-4 relative) and full float32 on the CPU; "
            "the spv gate shows the transform's own floor (~31 dB) "
            "unchanged by it")
WHY_SQPV = ("float32 prefix sums at precision HIGHEST on both backends in "
            "another summation order, ~1e-6 relative over a 1024-frame "
            "chunk")
WHY_LINEAR = ("float32 linear filtering (FFT convolution, polyphase "
              "einsum at HIGHEST, IIR as FIR, grain mixing); rounding "
              "differs ~1e-7 relative, so 80 dB leaves a wide margin")
WHY_LINEAR_SP = ("float32 FFT convolution or linear recurrence; block "
                 "splits reassociate rounding only (~1e-7 relative)")


class Context:
    """Scratch directory and devices shared by the phases, and the
    comparisons that failed so far (a failed comparison fails its phase
    after the phase has printed all of its values)."""

    def __init__(self, tmp: str):
        import jax
        self.tmp = tmp
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.card = "unknown card"
        self.failed = []

    def check(self, name: str, value: float, bound: float,
              higher_is_better: bool, why: str) -> None:
        ok = value >= bound if higher_is_better else value <= bound
        rel = ">=" if higher_is_better else "<="
        print(f"  check {name}: {value:.6g} (need {rel} {bound:g}; {why}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            self.failed.append(name)

    def compare(self, name: str, ref, got, *, min_snr_db=None,
                min_spectral_db=None, max_abs=None, why: str) -> None:
        """Waveform SNR and max-abs error are always printed; the named
        bounds are checked."""
        ref = np.asarray(ref)
        got = np.asarray(got)
        if ref.shape != got.shape:
            raise AssertionError(f"{name}: shape {got.shape} != "
                                 f"{ref.shape}")
        if not np.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values")
        from flan_tpu.utils.gates import snr_db
        snr = snr_db(ref, got, fit_scale=False)
        err = float(np.abs(ref - got).max())
        print(f"  {name}: snr_db {snr:.2f}, max_abs {err:.3g}", flush=True)
        if min_snr_db is not None:
            self.check(f"{name} snr_db", snr, min_snr_db, True, why)
        if min_spectral_db is not None:
            self.check(f"{name} spectral_snr_db",
                       spectral_snr_db(ref, got), min_spectral_db, True,
                       why)
        if max_abs is not None:
            self.check(f"{name} max_abs", err, max_abs, False, why)


def peak_bytes(device) -> int:
    """The device's high-water mark of bytes in use (-1 where the backend
    keeps no statistics)."""
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------- phases
def phase_gates(ctx):
    from flan_tpu.utils.gates import run_gates
    for name, (value, threshold) in run_gates().items():
        ctx.check(f"gate {name} dB", value, threshold, True,
                  "fixed before the port")


def phase_headline_cli(ctx):
    """10-minute stereo master, WAV on disk -> CLI stretch -> WAV on disk."""
    import jax
    import jax.numpy as jnp
    from flan_tpu import Audio, cli
    from flan_tpu.pipelines import pv_stretch_pipeline
    seconds = HEADLINE_S
    x = stereo_signal(seconds)
    in_wav = os.path.join(ctx.tmp, "master.wav")
    Audio.create_from_array(x, SR).save_to_file(in_wav)
    out_dir = os.path.join(ctx.tmp, "cli_out")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        if cli.main(["stretch", "--factor", "2.0", out_dir, in_wav]) != 0:
            raise AssertionError("cli stretch returned non-zero")
        walls.append(time.perf_counter() - t0)
    y = np.asarray(Audio.load_from_file(
        os.path.join(out_dir, "master.wav")).data)
    if y.shape != (2, 2 * (x.shape[1] // 128 + 1) * 128):
        raise AssertionError(f"output shape {y.shape} for input {x.shape}")
    for ch, hz in ((0, 220.0), (1, 330.0)):
        ctx.check(f"cli ch{ch} dominant_hz", abs(dominant_hz(y[ch]) - hz),
                  2.0, False, "a 2x stretch keeps the partial's frequency")
    print(f"  headline: CLI stretch of a {seconds:g} s stereo 48 kHz WAV on "
          f"{ctx.card}: {seconds / walls[1]:.2f} x realtime warm "
          f"({walls[1]:.3f} s; cold {walls[0]:.3f} s incl. compile), "
          "WAV read and write included", flush=True)

    xd = jax.device_put(jnp.asarray(x), ctx.gpu)
    fj = jax.jit(lambda v: pv_stretch_pipeline(v, 2.0, sample_rate=SR))
    y_mem = jax.block_until_ready(fj(xd))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fj(xd))
        best = min(best, time.perf_counter() - t0)
    print(f"  headline: compiled pipeline, device-resident input, on "
          f"{ctx.card}: {seconds / best:.2f} x realtime ({best:.4f} s)",
          flush=True)
    ctx.compare("cli_vs_in_memory", np.asarray(y_mem), y, max_abs=1e-5,
                why=WHY_SAME_PROGRAM)
    ctx.headline_in, ctx.headline_out = x, y
    print(f"  peak_bytes_in_use after headline: {peak_bytes(ctx.gpu)}")


def _on(device, fn, *arrays):
    """fn(*arrays) with the arrays and every new array on `device`."""
    import jax
    with jax.default_device(device):
        return jax.tree_util.tree_map(
            np.asarray, fn(*[jax.device_put(a, device) for a in arrays]))


def _cycles_err(ref_freq, got_freq, ref_mag, rate):
    """Largest circular difference, in cycles per hop, of two frequency
    planes at a hop rate, over bins within 40 dB of the peak."""
    d = (np.asarray(got_freq, np.float64)
         - np.asarray(ref_freq, np.float64)) / rate
    d = np.abs(d - np.round(d))
    return float(d[ref_mag > 1e-2 * ref_mag.max()].max())


def phase_headline_vs_cpu(ctx):
    """The headline pipeline on the card vs the CPU backend, 10 s."""
    from flan_tpu.ops.stft import pv_forward
    from flan_tpu.pipelines import pv_stretch_pipeline
    x = ctx.headline_in[:, :int(EXCERPT_S * SR)]

    def fwd(v):
        return pv_forward(v, sample_rate=SR)
    mag, freq = _on(ctx.gpu, fwd, x)
    mag_r, freq_r = _on(ctx.cpu, fwd, x)
    ctx.compare("pv_forward mag card_vs_cpu", mag_r, mag, min_snr_db=100.0,
                why=WHY_FFT)
    ctx.check("pv_forward freq card_vs_cpu cycles",
              _cycles_err(freq_r, freq, mag_r, SR / 128), 1e-4, False,
              WHY_CYCLES)

    def stretch(v):
        return pv_stretch_pipeline(v, 2.0, sample_rate=SR)
    ctx.compare("stretch card_vs_cpu", _on(ctx.cpu, stretch, x),
                _on(ctx.gpu, stretch, x), min_snr_db=40.0,
                min_spectral_db=60.0, why=WHY_DRIFT)


def phase_readme_api(ctx):
    """The README's example, materializing path, vs the streamed one."""
    import jax
    from flan_tpu import Audio
    from flan_tpu.pipelines import pv_stretch_pipeline
    n = int(API_S * SR)
    in_wav = os.path.join(ctx.tmp, "api_in.wav")
    out_wav = os.path.join(ctx.tmp, "api_out.wav")
    Audio.create_from_array(ctx.headline_in[:, :n], SR).save_to_file(in_wav)
    t0 = time.perf_counter()
    (Audio.load_from_file(in_wav).convert_to_PV().stretch(2.0)
     .convert_to_audio().save_to_file(out_wav))
    print(f"  README example ({API_S:g} s stereo): "
          f"{time.perf_counter() - t0:.3f} s incl. compile")
    unfused = np.asarray(Audio.load_from_file(out_wav).data)
    fused = np.asarray(pv_stretch_pipeline(
        jax.device_put(ctx.headline_in[:, :n], ctx.gpu), 2.0,
        sample_rate=SR))
    m = min(unfused.shape[-1], fused.shape[-1])
    ctx.compare("streamed_vs_materializing", unfused[:, :m],
                fused[:, :m], min_snr_db=60.0, why=WHY_FUSED)


def phase_materializing_full(ctx):
    """The materializing path at the headline's full length."""
    import jax
    from flan_tpu import Audio
    a = Audio(data=jax.device_put(ctx.headline_in, ctx.gpu), sample_rate=SR)
    t0 = time.perf_counter()
    pv = a.convert_to_PV()
    plane_bytes = 2 * pv.mag.size * 4
    y = np.asarray(pv.stretch(2.0).convert_to_audio().data)
    print(f"  materializing {HEADLINE_S:g} s stereo: "
          f"{time.perf_counter() - t0:.3f} s incl. compile; input PV "
          f"planes {plane_bytes} bytes; peak_bytes_in_use "
          f"{peak_bytes(ctx.gpu)} of "
          f"{(ctx.gpu.memory_stats() or {}).get('bytes_limit', -1)} "
          "-> fits", flush=True)
    del pv
    m = min(y.shape[-1], ctx.headline_out.shape[-1])
    ctx.compare("materializing_vs_cli", y[:, :m],
                ctx.headline_out[:, :m], min_snr_db=60.0, why=WHY_FUSED)


def phase_paths_vs_cpu(ctx):
    """Each translated path on the card against the CPU backend."""
    import jax.numpy as jnp
    from flan_tpu import Audio
    n = int(SHORT_S * SR)
    x = ctx.headline_in[:, :n]
    rng = np.random.default_rng(1)
    m_ir = int(0.25 * SR)
    ir = (rng.standard_normal(m_ir)
          * np.exp(-np.arange(m_ir) / 2000.0)).astype(np.float32)

    def audio(v):
        return Audio(data=v, sample_rate=SR)

    def spv(v):
        s = audio(v).convert_to_mono().convert_to_SPV(512)
        return s.mag, s.convert_to_audio().data

    def sqpv(v):
        s = audio(v).convert_to_mono().convert_to_SQPV((16.0, 24000.0),
                                                        24.0)
        return s.mag, s.convert_to_audio().data

    for name, fn, mag_db, wave_db, out_db, why in (
            ("spv", spv, 50.0, 45.0, 40.0, WHY_TF32),
            ("sqpv", sqpv, 90.0, 50.0, 60.0, WHY_SQPV)):
        mag, y = _on(ctx.gpu, fn, x)
        mag_r, y_r = _on(ctx.cpu, fn, x)
        ctx.compare(f"{name} forward mag card_vs_cpu", mag_r, mag,
                    min_snr_db=mag_db, why=why)
        ctx.compare(f"{name} round trip card_vs_cpu", y_r, y,
                    min_snr_db=wave_db, min_spectral_db=out_db,
                    why=WHY_ROUND_TRIP)

    linear = {
        "resample": lambda v: audio(v)._with(sample_rate=44100.0)
        .resample(48000.0).data,
        "filter_chain": lambda v: audio(v).filter_2pole_lowpass(
            8000.0, 0.5, 2).filter_2pole_highpass(60.0, 0.5, 2)
        .filter_1pole_lowshelf(200.0, 3.0).data,
        "convolve": lambda v: audio(v).convolve(
            Audio(data=jnp.asarray(ir)[None], sample_rate=SR)).data,
        "granulate": lambda v: audio(v).granulate(
            SHORT_S, 20.0, 0.1, lambda t: 0.5 * t, 0.1, 0.01,
            seed=0).data,
    }
    for name, fn in linear.items():
        ctx.compare(f"{name} card_vs_cpu", _on(ctx.cpu, fn, x),
                    _on(ctx.gpu, fn, x), min_snr_db=80.0, why=WHY_LINEAR)


def phase_bench_configs(ctx):
    """One run of each other bench.py configuration at its own size."""
    import bench
    for name in bench.OTHER_CONFIGS:
        t0 = time.perf_counter()
        res = getattr(bench, name)()
        res["seconds_incl_compile"] = round(time.perf_counter() - t0, 3)
        res["card"] = ctx.card
        print(f"  {json.dumps(res)}", flush=True)


# ---------------------------------------------------- four-card phase
def phase_multi(ctx):
    import jax
    import jax.numpy as jnp
    from flan_tpu import cli
    from flan_tpu import Audio
    from flan_tpu.ops.fft_conv import fft_convolve_full
    from flan_tpu.ops.scan import linear_recurrence
    from flan_tpu.parallel.conv_sp import convolve_sp
    from flan_tpu.parallel.mesh import make_mesh, seq_sharding
    from flan_tpu.parallel.scan_sp import linear_recurrence_sp
    from flan_tpu.parallel.stft_sp import stretch_sp_streamed
    from flan_tpu.pipelines import pv_stretch_pipeline

    devs = jax.devices()
    dev0 = devs[0]
    mesh = make_mesh(4, axis_name="sp")

    # 1. one long master sharded over time, made on the devices
    n = int(MULTI_LONG_S * SR)
    n -= n % 4

    @jax.jit
    def make(key):
        i = jnp.arange(n, dtype=jnp.int32) % int(SR)
        s0 = 0.4 * jnp.sin(2 * jnp.pi * ((i * 220) % int(SR)) / SR)
        s1 = 0.4 * jnp.sin(2 * jnp.pi * ((i * 330) % int(SR)) / SR)
        return (jnp.stack([s0, s1])
                + 0.1 * jax.random.normal(key, (2, n), jnp.float32))

    x_sh = jax.jit(make, out_shardings=seq_sharding(mesh, "sp"))(
        jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    y_sp = jax.block_until_ready(
        stretch_sp_streamed(x_sh, mesh, factor=2.0, sample_rate=SR))
    t_sp_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_sp = jax.block_until_ready(
        stretch_sp_streamed(x_sh, mesh, factor=2.0, sample_rate=SR))
    t_sp = time.perf_counter() - t0
    x0 = jax.device_put(x_sh, dev0)
    t0 = time.perf_counter()
    y1 = jax.block_until_ready(pv_stretch_pipeline(x0, 2.0, sample_rate=SR))
    t_1 = time.perf_counter() - t0
    print(f"  {MULTI_LONG_S:g} s stereo stretch: 4 cards "
          f"{MULTI_LONG_S / t_sp:.2f} x realtime ({t_sp:.3f} s warm, "
          f"{t_sp_cold:.3f} s cold); 1 card {t_1:.3f} s incl. compile",
          flush=True)
    m = min(y_sp.shape[-1], y1.shape[-1])
    y_sp0 = jax.device_put(y_sp, dev0)[:, :m]
    y1 = y1[:, :m]
    d = y_sp0 - y1
    wave_db = 10 * np.log10(float(jnp.sum(y1 * y1))
                            / max(float(jnp.sum(d * d)), 1e-30))
    ctx.check("sharded_stretch snr_db", wave_db, 120.0, True, WHY_SHARDED)
    ctx.check("sharded_stretch max_abs", float(jnp.max(jnp.abs(d))), 1e-6,
              False, WHY_SHARDED)
    del x_sh, y_sp, x0, y1, y_sp0, d

    # 2. the CLI's data-parallel batch
    paths = []
    for k in range(MULTI_CLIPS):
        p = os.path.join(ctx.tmp, f"clip{k}.wav")
        Audio.create_from_array(stereo_signal(MULTI_CLIP_S, seed=10 + k),
                                SR).save_to_file(p)
        paths.append(p)
    out_dir = os.path.join(ctx.tmp, "batch_out")
    t0 = time.perf_counter()
    if cli.main(["stretch", "--factor", "2.0", out_dir] + paths) != 0:
        raise AssertionError("cli batch stretch returned non-zero")
    print(f"  CLI batch of {len(paths)} x {MULTI_CLIP_S:g} s on 4 cards: "
          f"{time.perf_counter() - t0:.3f} s incl. compile", flush=True)
    for k, p in enumerate(paths):
        got = np.asarray(Audio.load_from_file(
            os.path.join(out_dir, os.path.basename(p))).data)
        ref = np.asarray(pv_stretch_pipeline(
            jax.device_put(stereo_signal(MULTI_CLIP_S, seed=10 + k), dev0),
            2.0, sample_rate=SR))
        if got.shape != ref.shape:
            raise AssertionError(f"clip {k}: {got.shape} != {ref.shape}")
        ctx.compare(f"batch clip{k}", ref, got, max_abs=1e-6,
                    why=WHY_SAME_PROGRAM)

    # 3. sharded convolution and recurrence
    xc = stereo_signal(MULTI_CLIP_S, seed=3)
    rng = np.random.default_rng(4)
    m_ir = int(min(1.0, MULTI_CLIP_S / 8) * SR)  # tail fits one shard
    h = (rng.standard_normal((2, m_ir)).astype(np.float32)
         * np.exp(-np.arange(m_ir) / 8000.0).astype(np.float32))
    got = np.asarray(convolve_sp(jnp.asarray(xc), jnp.asarray(h), mesh))
    ref = np.asarray(fft_convolve_full(jax.device_put(xc, dev0),
                                       jax.device_put(h, dev0)))
    ctx.compare("convolve_sp vs single", ref, got, min_snr_db=80.0,
                why=WHY_LINEAR_SP)
    a = np.full_like(xc, 0.999)
    got = np.asarray(linear_recurrence_sp(jnp.asarray(a), jnp.asarray(xc),
                                          mesh))
    ref = np.asarray(linear_recurrence(jax.device_put(a, dev0),
                                       jax.device_put(xc, dev0)))
    ctx.compare("linear_recurrence_sp vs single", ref, got,
                min_snr_db=80.0, why=WHY_LINEAR_SP)
    for dv in devs:
        print(f"  {dv}: peak_bytes_in_use {peak_bytes(dv)}")


PHASES = (("gates", phase_gates),
          ("headline_cli", phase_headline_cli),
          ("headline_vs_cpu", phase_headline_vs_cpu),
          ("readme_api", phase_readme_api),
          ("materializing_full", phase_materializing_full),
          ("paths_vs_cpu", phase_paths_vs_cpu),
          ("bench_configs", phase_bench_configs))
MULTI_PHASES = (("multi", phase_multi),)


def select_phases(multi: bool):
    return MULTI_PHASES if multi else PHASES


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def run(phases, expect_count: int) -> int:
    from flan_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 2
    if len(devices) < expect_count:
        print(f"chip_smoke: needs {expect_count} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    from jax import monitoring
    compile_s = [0.0]

    def on_duration(event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration
    monitoring.register_event_duration_secs_listener(on_duration)

    card = card_line()
    print(f"card: {card}")
    print(f"jax {jax.__version__}; devices: {len(devices)} x "
          f"{devices[0].device_kind}; compile cache: {cache_dir}")
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(tmp)
        ctx.card = card.splitlines()[0]
        for name, fn in phases:
            c0, t0 = compile_s[0], time.perf_counter()
            print(f"phase {name}: start", flush=True)
            n_failed = len(ctx.failed)
            try:
                fn(ctx)
            except Exception:  # noqa: BLE001 - reported; exit is non-zero
                traceback.print_exc()
                failed.append(name)
            if len(ctx.failed) > n_failed and name not in failed:
                failed.append(name)
            print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
                  f"{time.perf_counter() - t0:.3f} s "
                  f"(compile {compile_s[0] - c0:.3f} s)", flush=True)
    print(f"compile seconds total: {compile_s[0]:.3f}")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    return run(select_phases(args.multi), 4 if args.multi else 1)


if __name__ == "__main__":
    sys.exit(main())
