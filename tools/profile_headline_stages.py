"""Stage-ablation profile of the headline streamed stretch scan.

Copies pipelines/streamed.py's scan with per-stage stand-ins (cheap,
shape-preserving slices) so each stage's cost shows up as the delta
against the full program. Ablation totals won't sum exactly (fusion and
memory pressure shift), but they rank the stages, which is what the
optimization order needs.

Usage: python tools/profile_headline_stages.py VARIANT [SECONDS]
Variants: full, no_fwd_fft, no_phase, no_remap, no_cumsum, no_polar,
          no_inv_fft, no_ola, skeleton
Prints one JSON line. Subprocess-isolate per variant (one process per
card).
"""
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from flan_tpu.ops.stft import _cdiv, _wrap_radians, num_hops
from flan_tpu.ops.windows import hann_window


def _sync(y):
    jax.block_until_ready(y)


@functools.partial(
    jax.jit,
    static_argnames=("window_size", "hop", "dft_size", "sample_rate",
                     "out_frames", "max_hops_per_chunk", "chunk_out",
                     "ablate"))
def _scan(xs, time_map, *, window_size, hop, dft_size, sample_rate,
          out_frames, max_hops_per_chunk, chunk_out, ablate):
    _, c, n = xs.shape
    nh = time_map.shape[0]
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop
    n_in = xs.shape[0]

    window = hann_window(window_size)
    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / dft_size))
    expected = bin_freq / analysis_rate * (2.0 * jnp.pi)

    wpad = _cdiv(window_size, hop) * hop
    wblocks = wpad // hop
    r = wblocks
    inv_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    inv_window = jnp.zeros((wpad,), jnp.float32).at[:window_size].set(
        hann_window(window_size) * inv_scale)

    nchunks = _cdiv(out_frames, chunk_out)
    H = max_hops_per_chunk
    fpad = nchunks * chunk_out

    if "host_plan" in ablate:
        # plan computed in numpy and baked in as program constants; the
        # tool's map is always the constant-factor-2 stretch, so it is
        # reconstructed host-side from the static hop count
        tm_np = np.arange(1, nh + 1, dtype=np.float64) * 2.0
        xs_idx = np.arange(fpad, dtype=np.float64)
        idx = np.clip(np.searchsorted(tm_np, xs_idx, side="right"),
                      1, nh - 1)
        l = tm_np[idx - 1]
        rr = tm_np[idx]
        mix = np.clip((xs_idx - l) / np.where(rr == l, 1.0, rr - l),
                      0.0, 1.0)
        valid = ((xs_idx < out_frames) & (xs_idx >= tm_np[0])
                 & (xs_idx < tm_np[nh - 1]))
        i0 = jnp.asarray(idx.reshape(nchunks, chunk_out)[:, 0] - 1,
                         jnp.int32)
        li = (idx.reshape(nchunks, chunk_out) - 1
              - np.asarray(i0)[:, None])
        li = jnp.asarray(np.clip(li, 0, H - 3), jnp.int32)
        mix_s = jnp.asarray(mix.reshape(nchunks, chunk_out), jnp.float32)
        valid_s = jnp.asarray(valid.reshape(nchunks, chunk_out))
    else:
        xs_idx = jnp.arange(fpad, dtype=jnp.float32)
        idx = jnp.clip(jnp.searchsorted(time_map, xs_idx, side="right"),
                       1, nh - 1)
        l = time_map[idx - 1]
        rr = time_map[idx]
        mix = jnp.clip((xs_idx - l) / jnp.where(rr == l, 1.0, rr - l),
                       0.0, 1.0)
        valid = (xs_idx < out_frames) & (xs_idx >= time_map[0]) \
            & (xs_idx < time_map[nh - 1])
        i0 = idx.reshape(nchunks, chunk_out)[:, 0] - 1
        li = (idx.reshape(nchunks, chunk_out) - 1 - i0[:, None])
        li = jnp.clip(li, 0, H - 3).astype(jnp.int32)
        mix_s = mix.reshape(nchunks, chunk_out)
        valid_s = valid.reshape(nchunks, chunk_out)
    out_f0 = jnp.arange(nchunks, dtype=jnp.int32) * chunk_out

    left_pad = wpad + hop
    span_len = (H + wblocks + 1) * hop
    right_pad = span_len + left_pad
    xp = jnp.pad(xs, [(0, 0), (0, 0), (left_pad, right_pad)])
    span_start = (i0 - 1) * hop - (window_size // 2) + left_pad

    def forward_chunk(x_all, s0, i0_c):
        if "no_span" in ablate:
            # static slice + tiny perturbation keeps the data dependence
            # on s0 without the dynamic-start slice of the huge array
            span = (jax.lax.slice(x_all, (0, 0, 0), (n_in, c, span_len))
                    + s0.astype(jnp.float32) * 1e-12)
        else:
            span = jax.lax.dynamic_slice(
                x_all, (0, 0, s0), (n_in, c, span_len))
        rows = span.reshape(n_in, c, span_len // hop, hop)
        frames = jnp.stack(
            [rows[:, :, jj:jj + H, :] for jj in range(wblocks)],
            axis=3)
        frames = frames.reshape(n_in, c, H, wblocks * hop)[
            ..., :window_size]
        frames = frames * window[None, None, None, :]

        if "no_fwd_fft" in ablate:
            mag = jnp.pad(frames, [(0, 0)] * 3 + [(0, nbins - window_size)]) \
                if nbins > window_size else frames[..., :nbins]
            phase = mag * 0.5
        elif "no_phase" in ablate:
            spec = jnp.fft.rfft(frames, n=dft_size, axis=-1)
            mag, phase = jnp.real(spec), jnp.imag(spec)  # skip sqrt/arctan2
        else:
            from flan_tpu.ops.stft import rfft_mag_phase
            mag, phase = rfft_mag_phase(frames, dft_size)
        if "no_mid" in ablate:
            # keep framing + rfft + polar; skip phase-diff/wrap/freq
            return mag[:, :, 1:], phase[:, :, 1:]
        prev = jnp.concatenate(
            [jnp.zeros((n_in, c, 1, nbins), jnp.float32),
             phase[:, :, :-1]], axis=2)
        hop_ids = i0_c - 1 + jnp.arange(H)
        prev = jnp.where((hop_ids[None, None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, None, :])
        freq = bin_freq[None, None, None, :] + delta * (
            analysis_rate / (2.0 * jnp.pi))
        return mag[:, :, 1:], freq[:, :, 1:]

    def body(carry, inputs):
        cycle0, tail = carry
        s0, i0_c, li_c, mix_c, valid_c, f0 = inputs

        mag, freq = forward_chunk(xp, s0, i0_c)

        if "no_mid" in ablate:
            # cheap [H-1] -> [chunk] expansion; skip remap machinery,
            # phase diff and the cumsum — measures the FFTs + OLA + scan
            rep = -(-chunk_out // (H - 1)) + 1
            s_mag = jnp.concatenate([mag[0]] * rep, axis=1)[:, :chunk_out]
            s_pha = jnp.concatenate([freq[0]] * rep, axis=1)[:, :chunk_out]
            from flan_tpu.ops.stft import irfft_polar
            out_t = irfft_polar(s_mag, s_pha, dft_size)[..., :wpad]
            out_t = out_t * inv_window[None, None, :]
            blocks = out_t.reshape(c, chunk_out, r, hop)
            acc = jnp.zeros((c, chunk_out + r, hop), jnp.float32)
            acc = acc.at[:, :r, :].set(tail)
            for j in range(r):
                acc = acc.at[:, j:j + chunk_out, :].add(blocks[:, :, j, :])
            out = acc[:, :chunk_out, :].reshape(c, chunk_out * hop)
            new_tail = acc[:, chunk_out:, :]
            return (cycle0, new_tail), out

        if "no_remap" in ablate:
            s_mag = jnp.broadcast_to(mag[0, :, :1], (c, chunk_out, nbins))
            s_freq = jnp.broadcast_to(freq[0, :, :1], (c, chunk_out, nbins))
        else:
            w0 = (1.0 - mix_c)[None, None, :, None] * mag[:, :, li_c]
            w1 = mix_c[None, None, :, None] * mag[:, :, li_c + 1]
            total = w0 + w1
            fsum = w0 * freq[:, :, li_c] + w1 * freq[:, :, li_c + 1]
            v = valid_c[None, None, :, None]
            s_mag = jnp.where(v, total, 0.0)
            s_freq = jnp.where(
                v & (total > 0.0),
                fsum / jnp.where(total > 0.0, total, 1.0), 0.0)
            s_mag, s_freq = s_mag[0], s_freq[0]

        from flan_tpu.ops.stft import cumsum_mod1_frames, irfft_polar
        inc = jnp.mod(s_freq / analysis_rate, 1.0)
        if "no_cumsum" in ablate:
            cycles = inc
        else:
            cycles = cumsum_mod1_frames(inc)
        cycles = jnp.mod(cycles + cycle0[:, None, :], 1.0)
        if "no_inv_fft" in ablate:
            out_t = jnp.pad(s_mag + cycles,
                            [(0, 0), (0, 0), (0, wpad - nbins)]) \
                if wpad > nbins else (s_mag + cycles)[..., :wpad]
        elif "no_polar" in ablate:
            out_t = jnp.fft.irfft(jax.lax.complex(s_mag, cycles),
                                  n=dft_size, axis=-1)[..., :wpad]
        else:
            out_t = irfft_polar(s_mag, cycles * (2.0 * jnp.pi),
                                dft_size)[..., :wpad]
        out_t = out_t * inv_window[None, None, :]

        if "no_ola" in ablate:
            out = out_t[:, :, :hop].reshape(c, chunk_out * hop)
            new_tail = tail
        else:
            blocks = out_t.reshape(c, chunk_out, r, hop)
            acc = jnp.zeros((c, chunk_out + r, hop), jnp.float32)
            acc = acc.at[:, :r, :].set(tail)
            for j in range(r):
                acc = acc.at[:, j:j + chunk_out, :].add(blocks[:, :, j, :])
            out = acc[:, :chunk_out, :].reshape(c, chunk_out * hop)
            new_tail = acc[:, chunk_out:, :]
        return (cycles[:, -1, :], new_tail), out

    init = (jnp.zeros((c, nbins), jnp.float32),
            jnp.zeros((c, r, hop), jnp.float32))
    (_, tail), outs = jax.lax.scan(
        body, init, (span_start, i0, li, mix_s, valid_s, out_f0))
    body_audio = outs.transpose(1, 0, 2).reshape(c, fpad * hop)
    audio = jnp.concatenate([body_audio, tail.reshape(c, r * hop)], axis=-1)
    shift = window_size // 2
    return audio[:, shift:shift + out_frames * hop]


VARIANTS = ("full", "no_fwd_fft", "no_phase", "no_remap", "no_cumsum",
            "no_polar", "no_inv_fft", "no_ola", "skeleton", "host_plan",
            "no_mid", "no_span")


def main():
    variant = sys.argv[1]
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 150.0
    chunk_out = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    channels = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    assert variant in VARIANTS, variant
    ablate = () if variant == "full" else (
        ("no_fwd_fft", "no_remap", "no_cumsum", "no_inv_fft", "no_ola")
        if variant == "skeleton" else (variant,))

    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray(np.stack([
        0.4 * np.sin(2 * np.pi * (220.0 + 10 * c) * t)
        + 0.1 * rng.standard_normal(n) for c in range(channels)
    ]).astype(np.float32))

    hop, window_size, dft_size = 128, 2048, 4096
    nh = num_hops(n, hop)
    tm = np.arange(1, nh + 1, dtype=np.float64) * 2.0
    out_frames = int(np.ceil(tm.max()))
    min_step = 2.0
    max_hops = int(np.ceil(chunk_out / min_step)) + 4

    xs = x[None]

    def run():
        return _scan(xs, jnp.asarray(tm, jnp.float32),
                     window_size=window_size, hop=hop, dft_size=dft_size,
                     sample_rate=sr, out_frames=out_frames,
                     max_hops_per_chunk=max_hops, chunk_out=chunk_out,
                     ablate=ablate)

    y = run()
    _sync(y)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _sync(run())
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "variant": variant, "seconds": seconds, "chunk_out": chunk_out,
        "channels": channels, "ms": round(best * 1e3, 1),
        "x_realtime": round(seconds / best, 1)}))


if __name__ == "__main__":
    main()
