"""A/B: fold clips as channels vs interleave their chunks across scan
steps.

Hypothesis under test: the headline scan is latency-bound per step, and
folding a second clip into the channel axis (bench_batch's fold-2,
[4, n] per program) widens every per-step tensor, and per-step cost may
rise superlinearly once the working set outgrows on-chip memory.
Interleaving instead keeps each step at the single-clip 2-channel
working set and alternates steps between two clips with a rotated PAIR
of carries (carry dependency distance 2): same total work, same number
of dispatched programs, but per-step tensors stay at the 2-channel
optimum and consecutive steps are data-independent.

Both arms run the same scan body (a faithful copy of
pipelines/streamed.py's constant-factor host-planned stretch, like
tools/profile_headline_stages.py) so the comparison isolates the
batching axis. Reference analog being beaten either way: the
reference's thread scheduler (Utility/execution.h:75-86).

Usage: python tools/ab_batch_interleave.py fold|interleave [SECONDS] [CHUNK]
Prints one JSON line with aggregate x-realtime over 2 clips.
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
                     "interleave", "nh"))
def _scan(xs, *, window_size, hop, dft_size, sample_rate, out_frames,
          max_hops_per_chunk, chunk_out, interleave, nh):
    """xs: [K, c, n] — K independent clips. interleave=False runs one
    standard scan over the channel-folded [K*c, n]; True runs a
    2K*nchunks-step scan alternating clips with a rotated carry pair."""
    k_clips, c, n = xs.shape
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop

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

    # constant-factor-2 host plan (identical to the ship path's
    # precomputed remap rows for a constant-rate map)
    tm_np = np.arange(1, nh + 1, dtype=np.float64) * 2.0
    xs_idx = np.arange(fpad, dtype=np.float64)
    idx = np.clip(np.searchsorted(tm_np, xs_idx, side="right"), 1, nh - 1)
    l = tm_np[idx - 1]
    rr_ = tm_np[idx]
    mix = np.clip((xs_idx - l) / np.where(rr_ == l, 1.0, rr_ - l), 0.0, 1.0)
    valid = ((xs_idx < out_frames) & (xs_idx >= tm_np[0])
             & (xs_idx < tm_np[nh - 1]))
    i0_np = idx.reshape(nchunks, chunk_out)[:, 0] - 1
    i0 = jnp.asarray(i0_np, jnp.int32)
    li = jnp.asarray(np.clip(idx.reshape(nchunks, chunk_out) - 1
                             - i0_np[:, None], 0, H - 3), jnp.int32)
    mix_s = jnp.asarray(mix.reshape(nchunks, chunk_out), jnp.float32)
    valid_s = jnp.asarray(valid.reshape(nchunks, chunk_out))

    left_pad = wpad + hop
    span_len = (H + wblocks + 1) * hop
    right_pad = span_len + left_pad
    xp = jnp.pad(xs, [(0, 0), (0, 0), (left_pad, right_pad)])
    span_start = (i0 - 1) * hop - (window_size // 2) + left_pad

    def forward_chunk(span, i0_c, cc):
        rows = span.reshape(cc, span_len // hop, hop)
        frames = jnp.stack(
            [rows[:, jj:jj + H, :] for jj in range(wblocks)], axis=2)
        frames = frames.reshape(cc, H, wblocks * hop)[..., :window_size]
        frames = frames * window[None, None, :]
        from flan_tpu.ops.stft import rfft_mag_phase
        mag, phase = rfft_mag_phase(frames, dft_size)
        prev = jnp.concatenate(
            [jnp.zeros((cc, 1, nbins), jnp.float32), phase[:, :-1]], axis=1)
        hop_ids = i0_c - 1 + jnp.arange(H)
        prev = jnp.where((hop_ids[None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (analysis_rate
                                                  / (2.0 * jnp.pi))
        return mag[:, 1:], freq[:, 1:]

    def chunk_body(span, i0_c, li_c, mix_c, valid_c, cycle0, tail, cc):
        mag, freq = forward_chunk(span, i0_c, cc)
        w0 = (1.0 - mix_c)[None, :, None] * mag[:, li_c]
        w1 = mix_c[None, :, None] * mag[:, li_c + 1]
        total = w0 + w1
        fsum = w0 * freq[:, li_c] + w1 * freq[:, li_c + 1]
        v = valid_c[None, :, None]
        s_mag = jnp.where(v, total, 0.0)
        s_freq = jnp.where(v & (total > 0.0),
                           fsum / jnp.where(total > 0.0, total, 1.0), 0.0)
        from flan_tpu.ops.stft import cumsum_mod1_frames, irfft_polar
        inc = jnp.mod(s_freq / analysis_rate, 1.0)
        cycles = jnp.mod(cumsum_mod1_frames(inc) + cycle0[:, None, :], 1.0)
        out_t = irfft_polar(s_mag, cycles * (2.0 * jnp.pi), dft_size)[..., :wpad]
        out_t = out_t * inv_window[None, None, :]
        blocks = out_t.reshape(cc, chunk_out, r, hop)
        acc = jnp.zeros((cc, chunk_out + r, hop), jnp.float32)
        acc = acc.at[:, :r, :].set(tail)
        for j in range(r):
            acc = acc.at[:, j:j + chunk_out, :].add(blocks[:, :, j, :])
        out = acc[:, :chunk_out, :].reshape(cc, chunk_out * hop)
        return cycles[:, -1, :], acc[:, chunk_out:, :], out

    if not interleave:
        cc = k_clips * c
        xf = xp.reshape(cc, -1)

        def body(carry, inputs):
            cycle0, tail = carry
            s0, i0_c, li_c, mix_c, valid_c = inputs
            span = jax.lax.dynamic_slice(xf, (0, s0), (cc, span_len))
            cyc, new_tail, out = chunk_body(span, i0_c, li_c, mix_c,
                                            valid_c, cycle0, tail, cc)
            return (cyc, new_tail), out

        init = (jnp.zeros((cc, nbins), jnp.float32),
                jnp.zeros((cc, r, hop), jnp.float32))
        (_, tail), outs = jax.lax.scan(
            body, init, (span_start, i0, li, mix_s, valid_s))
        body_audio = outs.transpose(1, 0, 2).reshape(cc, fpad * hop)
        audio = jnp.concatenate([body_audio, tail.reshape(cc, r * hop)],
                                axis=-1)
        audio = audio.reshape(k_clips, c, -1)
    else:
        # interleaved: step t processes clip t % K, chunk t // K, with a
        # rotated carry queue of K (cycle, tail) pairs — consecutive
        # steps are data-independent, per-step tensors stay [c, ...]
        rep = lambda a: jnp.repeat(a, k_clips, axis=0)  # noqa: E731
        clip_ids = jnp.tile(jnp.arange(k_clips, dtype=jnp.int32), nchunks)

        def body(carry, inputs):
            cycles_q, tails_q = carry          # [K, c, ...] queues
            s0, i0_c, li_c, mix_c, valid_c, clip = inputs
            span = jax.lax.dynamic_slice(
                xp, (clip, 0, s0), (1, c, span_len))[0]
            cyc, new_tail, out = chunk_body(span, i0_c, li_c, mix_c,
                                            valid_c, cycles_q[0],
                                            tails_q[0], c)
            cycles_q = jnp.concatenate([cycles_q[1:], cyc[None]], axis=0)
            tails_q = jnp.concatenate([tails_q[1:], new_tail[None]],
                                      axis=0)
            return (cycles_q, tails_q), out

        init = (jnp.zeros((k_clips, c, nbins), jnp.float32),
                jnp.zeros((k_clips, c, r, hop), jnp.float32))
        (_, tails), outs = jax.lax.scan(
            body, init,
            (rep(span_start), rep(i0), rep(li), rep(mix_s), rep(valid_s),
             clip_ids))
        # outs: [nchunks*K, c, chunk*hop] -> per-clip streams
        body_audio = (outs.reshape(nchunks, k_clips, c, chunk_out * hop)
                      .transpose(1, 2, 0, 3)
                      .reshape(k_clips, c, fpad * hop))
        audio = jnp.concatenate(
            [body_audio, tails.reshape(k_clips, c, r * hop)], axis=-1)

    shift = window_size // 2
    return audio[:, :, shift:shift + out_frames * hop]


def main():
    arm = sys.argv[1]
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 150.0
    chunk_out = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    k_clips = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    assert arm in ("fold", "interleave", "check")

    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    clips = np.stack([
        np.stack([0.4 * np.sin(2 * np.pi * (220.0 + 10 * kk + 5 * c) * t)
                  + 0.1 * rng.standard_normal(n) for c in range(2)])
        for kk in range(k_clips)]).astype(np.float32)
    xs = jnp.asarray(clips)

    hop, window_size, dft_size = 128, 2048, 4096
    nh = num_hops(n, hop)
    out_frames = int(np.ceil(nh * 2.0))
    max_hops = int(np.ceil(chunk_out / 2.0)) + 4

    def run(interleave):
        return _scan(xs, window_size=window_size, hop=hop,
                     dft_size=dft_size, sample_rate=sr,
                     out_frames=out_frames, max_hops_per_chunk=max_hops,
                     chunk_out=chunk_out, interleave=interleave, nh=nh)

    if arm == "check":
        ya = np.asarray(run(False))
        yb = np.asarray(run(True))
        err = float(np.abs(ya - yb).max())
        print(json.dumps({"arm": "check", "max_abs_diff": err,
                          "ok": err < 1e-4}))
        return

    interleave = arm == "interleave"
    y = run(interleave)
    _sync(y)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _sync(run(interleave))
        best = min(best, time.perf_counter() - t0)
    total_audio = seconds * k_clips
    print(json.dumps({
        "arm": arm, "seconds": seconds, "chunk_out": chunk_out,
        "k_clips": k_clips, "ms": round(best * 1e3, 1),
        "aggregate_x_realtime": round(total_audio / best, 1)}))


if __name__ == "__main__":
    main()
