"""Sequence-parallel phase vocoder: audio sharded along time over a mesh.

The reference has no distributed execution (SURVEY.md section 2 audit); this
is the green-field multi-chip design for long audio - the audio analog of
context parallelism (SURVEY.md section 5):

* forward: each device owns a contiguous span of PV hops. Analysis windows
  reach window/2 samples past the span edges, so devices exchange halo
  blocks with `jax.lax.ppermute` (ring neighbors over ICI), then run the
  ordinary batched STFT + lag-1 phase diff locally. The previous-hop phase
  for the first local hop is recomputed from the halo - no sequential
  cross-device dependency.

* inverse: the mod-1 cycle accumulation needs a global prefix. Each device
  scans its local increments, all-gathers the tiny per-device totals
  ([devices, C, B]), and adds the exclusive prefix of its predecessors -
  one small collective instead of a sequential pass. The overlap-add tail
  (window of audio) is ppermuted to the right neighbor and summed.

Run under `jax.shard_map` on a 1-D mesh; validated against the single-chip
ops on a virtual CPU mesh in tests/test_multichip.py.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flan_tpu.ops.stft import (_cdiv, _wrap_radians, cumsum_mod1_frames,
                               num_hops)
from flan_tpu.ops.windows import hann_window

from jax import shard_map


def pv_forward_sp(x: jnp.ndarray, mesh: Mesh, *, window_size: int = 2048,
                  hop: int = 128, dft_size: int = 4096,
                  sample_rate: float = 48000.0, axis: str = "sp"):
    """Audio [C, N] -> (mag, freq) [C, nh_padded, B], frame-sharded.

    Output rows beyond num_hops(N, hop) are padding (zero signal).
    """
    c, n = x.shape
    d = mesh.shape[axis]
    nh = num_hops(n, hop)
    nh_local = _cdiv(nh, d)
    nh_pad = nh_local * d
    nbins = dft_size // 2 + 1
    analysis_rate = sample_rate / hop

    # pad signal so each device's span is clean: device i owns hops
    # [i*nh_local, (i+1)*nh_local); its windows read
    # [i*nh_local*hop - w/2 - hop, ...). Give each shard equal length.
    n_local = nh_local * hop
    n_pad = n_local * d
    xp = jnp.pad(x, [(0, 0), (0, n_pad - n)])

    window = hann_window(window_size)
    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / dft_size))
    expected = bin_freq / analysis_rate * (2.0 * jnp.pi)
    # halo: left needs window/2 + hop (helper prev-phase hop), right needs
    # window/2; one symmetric block, bounded by the shard size
    halo = window_size // 2 + hop
    if halo > n_local:
        raise ValueError(
            "shard too small for the analysis window halo; use fewer "
            "devices or longer audio")

    def kernel(x_local):
        # x_local: [C, n_local]
        idx = jax.lax.axis_index(axis)
        left = jax.lax.ppermute(
            x_local[:, -halo:], axis,
            [(i, (i + 1) % d) for i in range(d)])
        right = jax.lax.ppermute(
            x_local[:, :halo], axis,
            [(i, (i - 1) % d) for i in range(d)])
        left = jnp.where(idx == 0, 0.0, left)        # no wraparound signal
        right = jnp.where(idx == d - 1, 0.0, right)
        span = jnp.concatenate([left, x_local, right], axis=-1)

        # local hops j = 0..nh_local-1 are global hops idx*nh_local + j;
        # plus one helper hop for the previous phase
        h_count = nh_local + 1
        starts = (jnp.arange(h_count) - 1) * hop - window_size // 2 + halo
        fidx = starts[:, None] + jnp.arange(window_size)[None, :]
        # global sample bounds
        g0 = idx * n_local - halo
        gidx = fidx + g0
        valid = (gidx >= 0) & (gidx < n)
        framed = jnp.take(span, jnp.clip(fidx, 0, span.shape[-1] - 1),
                          axis=-1)
        framed = jnp.where(valid[None], framed, 0.0) * window[None, None, :]
        from flan_tpu.ops.stft import rfft_mag_phase
        mag, phase = rfft_mag_phase(framed, dft_size)
        prev = jnp.concatenate(
            [jnp.zeros((c, 1, nbins), jnp.float32), phase[:, :-1]], axis=1)
        hop_ids = idx * nh_local + jnp.arange(h_count) - 1
        prev = jnp.where((hop_ids[None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (analysis_rate
                                                   / (2.0 * jnp.pi))
        return mag[:, 1:], freq[:, 1:].astype(jnp.float32)

    fn = shard_map(kernel, mesh=mesh, in_specs=P(None, axis),
                   out_specs=(P(None, axis), P(None, axis)))
    return fn(xp)


def pv_inverse_sp(mag: jnp.ndarray, freq: jnp.ndarray, mesh: Mesh, *,
                  window_size: int = 2048, hop: int = 128,
                  sample_rate: float = 48000.0, axis: str = "sp"):
    """(mag, freq) [C, F, B] frame-sharded -> audio [C, F * hop] sharded.

    F must divide evenly by the mesh size (pad frames with zero magnitude).
    """
    c, f, nbins = mag.shape
    d = mesh.shape[axis]
    assert f % d == 0, "pad PV frames to a multiple of the mesh size"
    f_local = f // d
    dft_size = 2 * (nbins - 1)
    analysis_rate = sample_rate / hop

    wpad = _cdiv(window_size, hop) * hop
    r = wpad // hop
    if r * hop > f_local * hop:
        raise ValueError("shard too small for the overlap-add tail")
    inv_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    window = jnp.zeros((wpad,), jnp.float32).at[:window_size].set(
        hann_window(window_size) * inv_scale)

    def kernel(m, fr):
        idx = jax.lax.axis_index(axis)
        inc = jnp.mod(fr / analysis_rate, 1.0)
        # tiled matmul prefix, not associative_scan over the long frame
        # axis (see ops/scan.py)
        cycles = cumsum_mod1_frames(inc)
        # cross-device prefix: all-gather per-device totals (tiny), add
        # the exclusive mod-1 prefix of predecessors
        totals = jax.lax.all_gather(cycles[:, -1, :], axis)  # [D, C, B]
        ranks = jnp.arange(d)[:, None, None]
        prefix = jnp.sum(jnp.where(ranks < idx, totals, 0.0), axis=0)
        cycles = jnp.mod(cycles + jnp.mod(prefix, 1.0)[:, None, :], 1.0)

        from flan_tpu.ops.stft import irfft_polar
        frames = irfft_polar(m, cycles * (2.0 * jnp.pi),
                             dft_size)[..., :wpad]
        frames = frames * window[None, None, :]
        blocks = frames.reshape(c, f_local, r, hop)
        acc = jnp.zeros((c, f_local + r, hop), jnp.float32)
        for j in range(r):
            acc = acc.at[:, j:j + f_local, :].add(blocks[:, :, j, :])
        # ship the overhanging tail to the right neighbor's head; the last
        # device's tail is returned (replicated) for the final samples
        tail = acc[:, f_local:, :]
        shifted = jax.lax.ppermute(
            tail, axis, [(i, (i + 1) % d) for i in range(d)])
        shifted = jnp.where(idx == 0, 0.0, shifted)
        acc = acc.at[:, :r, :].add(shifted)
        last_tail = jax.lax.psum(
            jnp.where(idx == d - 1, tail, 0.0), axis)
        return acc[:, :f_local, :].reshape(c, f_local * hop), last_tail

    fn = shard_map(kernel, mesh=mesh, in_specs=(P(None, axis, None),
                                                P(None, axis, None)),
                   out_specs=(P(None, axis), P(None, None, None)))
    audio, last_tail = fn(mag, freq)
    # stream = device bodies ++ final tail; the single-chip slice is
    # stream[window/2 : window/2 + F*hop] (ops.stft.pv_inverse).
    stream = jnp.concatenate(
        [audio, last_tail.reshape(c, r * hop)], axis=-1)
    shift = window_size // 2
    return stream[:, shift:shift + f * hop]


def streamed_sp_process(xs_list, mesh, chunk_op=None, *, time_map=None,
                        window_size: int = 2048, hop: int = 128,
                        dft_size: int = 4096, sample_rate: float = 48000.0,
                        axis: str = "sp", chunk_out: int = 256):
    """Sequence-parallel AND streamed PV pipeline harness: each shard runs the
    O(chunk)-HBM streamed harness (pipelines/streamed.py) over its own
    output span, so a sharded hour-long pipeline never materializes
    per-shard PV tensors (stretch_sp holds [C, H_local, B] per device -
    the 2x-overlap-factor blowup streaming was built to avoid).

    xs_list: list of [C, N] inputs (shorter ones zero-padded); chunk_op
    (mags, freqs, f0) -> (mag, freq), identical contract to
    pipelines/streamed.streamed_pv_process with f0 the chunk's GLOBAL
    first output-frame index; time_map: per-input-hop monotone output
    positions (None = identity, frame-aligned ops).

    Cross-device sequential state:
    * inverse phase prefix: the mod-1 cycle total of a shard is only known
      after its chunks are scanned, so the kernel runs TWO passes: pass 1
      scans forward+remap+chunk_op accumulating the per-shard cycle total
      (no synthesis - XLA dead-code-eliminates the irfft), one all_gather
      of the tiny [D, C, B] totals, then pass 2 re-runs the scan with each
      shard's exclusive prefix offset and synthesizes. ~1.4x compute for
      O(chunk) memory; for audio long enough to shard, the alternative is
      not fitting at all.
    * overlap-add tail: each shard's final chunk tail is ppermuted to the
      right neighbor and added onto its first window of output (the tail
      handoff of pv_inverse_sp, lifted out of the scan).

    Per-device peak HBM: the all_gathered raw audio [n_in, C, N]
    (window/hop * 2 = 32x smaller than the PV tensors at default params)
    plus O(chunk_out x bins) scan state. Matches the single-chip streamed
    pipelines (asserted in tests/test_multichip.py and
    __graft_entry__.dryrun_multichip).
    """
    from flan_tpu.ops.stft import (cumsum_mod1_frames, irfft_polar,
                                   rfft_mag_phase)

    n = max(int(x.shape[-1]) for x in xs_list)
    c = int(xs_list[0].shape[0])
    for x in xs_list:
        if int(x.shape[0]) != c:
            raise ValueError("streamed_sp_process requires equal channels")
    n_in = len(xs_list)
    d = mesh.shape[axis]
    nh = num_hops(n, hop)
    analysis_rate = sample_rate / hop
    nbins = dft_size // 2 + 1

    if time_map is None:
        # identity plan: output frame j = input hop j exactly (see
        # pipelines/streamed.streamed_pv_process for the trailing entry)
        tm = np.arange(nh + 1, dtype=np.float64)
        out_frames = nh
    else:
        tm = np.asarray(time_map, np.float64)
        out_frames = int(math.ceil(float(np.max(tm))))
    nt = tm.shape[0]

    # ---- host: chunked gather plan, sharded by output span ----
    nchunks_local = _cdiv(_cdiv(out_frames, d), chunk_out)
    oh_local = nchunks_local * chunk_out
    fpad = oh_local * d
    nchunks = nchunks_local * d

    xs = np.arange(fpad, dtype=np.float64)
    raw_idx = np.searchsorted(tm, xs, side="right")
    valid = ((raw_idx >= 1) & (raw_idx <= nt - 1) & (xs < out_frames)
             & (xs >= tm[0]))
    idx = np.clip(raw_idx, 1, nt - 1)
    l = tm[idx - 1]
    rr = tm[idx]
    mix = np.clip((xs - l) / np.where(rr == l, 1.0, rr - l), 0.0, 1.0)

    idx_c = idx.reshape(nchunks, chunk_out)
    i0 = idx_c[:, 0] - 1                              # [nchunks]
    H = int((idx_c.max(axis=1) - i0).max()) + 2       # pair + helper hop
    li = (idx_c - 1 - i0[:, None]).astype(np.int32)   # chunk-local pairs

    wpad = _cdiv(window_size, hop) * hop
    r = wpad // hop
    if oh_local < r:
        raise ValueError("output shard shorter than the overlap-add tail; "
                         "use fewer devices or longer audio")

    window = hann_window(window_size)
    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / dft_size))
    expected = bin_freq / analysis_rate * (2.0 * jnp.pi)
    inv_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    inv_window = jnp.zeros((wpad,), jnp.float32).at[:window_size].set(
        hann_window(window_size) * inv_scale)

    n_local = _cdiv(n, d)
    stacked = jnp.stack(
        [jnp.pad(x, [(0, 0), (0, n_local * d - int(x.shape[-1]))])
         for x in xs_list])                           # [n_in, C, n_pad]
    left_pad = wpad + hop
    span_len = (H + r + 1) * hop
    span_start_np = (i0 - 1) * hop - window_size // 2 + left_pad

    # per-device chunk plans, sharded along the leading axis
    sp_dev = jnp.asarray(span_start_np.reshape(d, nchunks_local), jnp.int32)
    i0_dev = jnp.asarray(i0.reshape(d, nchunks_local), jnp.int32)
    li_dev = jnp.asarray(li.reshape(d, nchunks_local, chunk_out), jnp.int32)
    mix_dev = jnp.asarray(mix.reshape(d, nchunks_local, chunk_out),
                          jnp.float32)
    valid_dev = jnp.asarray(valid.reshape(d, nchunks_local, chunk_out))
    f0_dev = jnp.asarray(
        (np.arange(nchunks, dtype=np.int32) * chunk_out)
        .reshape(d, nchunks_local))

    def chunk_core(xf, s0, i0_c, li_c, mix_c, valid_c, f0):
        """forward PV + monotonic remap + chunk_op for one chunk."""
        span = jax.lax.dynamic_slice(
            xf, (0, 0, s0), (n_in, c, span_len))
        rows = span.reshape(n_in, c, span_len // hop, hop)
        frames = jnp.stack([rows[:, :, jj:jj + H, :] for jj in range(r)],
                           axis=3)
        frames = frames.reshape(n_in, c, H, r * hop)[..., :window_size]
        frames = frames * window[None, None, None, :]
        mag, phase = rfft_mag_phase(frames, dft_size)  # [n_in, C, H, B]
        prev = jnp.concatenate(
            [jnp.zeros((n_in, c, 1, nbins), jnp.float32),
             phase[:, :, :-1]], axis=2)
        hop_ids = i0_c - 1 + jnp.arange(H)
        prev = jnp.where((hop_ids[None, None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, None, :])
        freq = bin_freq[None, None, None, :] + delta * (
            analysis_rate / (2.0 * jnp.pi))
        mag, freq = mag[:, :, 1:], freq[:, :, 1:]    # drop helper hop
        # WFS remap policy (PVModify.cpp:344-355), per input
        w0 = (1.0 - mix_c)[None, None, :, None] * mag[:, :, li_c]
        w1 = mix_c[None, None, :, None] * mag[:, :, li_c + 1]
        total = w0 + w1
        fsum = w0 * freq[:, :, li_c] + w1 * freq[:, :, li_c + 1]
        v = valid_c[None, None, :, None]
        s_mag = jnp.where(v, total, 0.0)
        s_freq = jnp.where(v & (total > 0.0),
                           fsum / jnp.where(total > 0.0, total, 1.0), 0.0)
        if chunk_op is not None:
            return chunk_op(s_mag, s_freq, f0)
        return s_mag[0], s_freq[0]

    def kernel(x_local, sp_c, i0_c, li_c, mix_c, valid_c, f0_c):
        idx_dev = jax.lax.axis_index(axis)
        full = jax.lax.all_gather(x_local, axis, axis=2, tiled=True)
        xf = jnp.pad(full, [(0, 0), (0, 0),
                            (left_pad, span_len + left_pad)])
        sp_l = sp_c[0]          # [nchunks_local] (leading dev axis sharded)
        i0_l, li_l, mix_l, valid_l, f0_l = (i0_c[0], li_c[0], mix_c[0],
                                            valid_c[0], f0_c[0])

        # ---- pass 1: per-shard mod-1 cycle total (no synthesis) ----
        def body_total(total0, inputs):
            s0, i0_k, li_k, mix_k, valid_k, f0_k = inputs
            _, s_freq = chunk_core(xf, s0, i0_k, li_k, mix_k, valid_k,
                                   f0_k)
            inc = jnp.mod(s_freq / analysis_rate, 1.0)
            last = cumsum_mod1_frames(inc)[:, -1, :]
            return jnp.mod(total0 + last, 1.0), None

        total, _ = jax.lax.scan(
            body_total,
            jax.lax.pcast(jnp.zeros((c, nbins), jnp.float32), (axis,),
                          to="varying"),
            (sp_l, i0_l, li_l, mix_l, valid_l, f0_l))

        totals = jax.lax.all_gather(total, axis)          # [D, C, B]
        ranks = jnp.arange(d)[:, None, None]
        prefix = jnp.mod(
            jnp.sum(jnp.where(ranks < idx_dev, totals, 0.0), axis=0), 1.0)

        # ---- pass 2: streamed synthesis with the device phase offset ----
        def body(carry, inputs):
            cycle0, tail = carry
            s0, i0_k, li_k, mix_k, valid_k, f0_k = inputs
            s_mag, s_freq = chunk_core(xf, s0, i0_k, li_k, mix_k, valid_k,
                                       f0_k)
            inc = jnp.mod(s_freq / analysis_rate, 1.0)
            cycles = jnp.mod(cumsum_mod1_frames(inc) + cycle0[:, None, :],
                             1.0)
            out_t = irfft_polar(s_mag, cycles * (2.0 * jnp.pi),
                                dft_size)[..., :wpad]
            out_t = out_t * inv_window[None, None, :]
            blocks = out_t.reshape(c, chunk_out, r, hop)
            acc = jnp.zeros((c, chunk_out + r, hop), jnp.float32)
            acc = acc.at[:, :r, :].set(tail)
            for j in range(r):
                acc = acc.at[:, j:j + chunk_out, :].add(blocks[:, :, j, :])
            out = acc[:, :chunk_out, :].reshape(c, chunk_out * hop)
            return (cycles[:, -1, :], acc[:, chunk_out:, :]), out

        init = (prefix,
                jax.lax.pcast(jnp.zeros((c, r, hop), jnp.float32), (axis,),
                              to="varying"))
        (_, tail), outs = jax.lax.scan(
            body, init, (sp_l, i0_l, li_l, mix_l, valid_l, f0_l))
        body_audio = outs.transpose(1, 0, 2).reshape(c, oh_local * hop)

        # ---- cross-device OLA tail handoff (outside the scan) ----
        shifted = jax.lax.ppermute(
            tail, axis, [(i, (i + 1) % d) for i in range(d)])
        shifted = jnp.where(idx_dev == 0, 0.0, shifted)
        head = (body_audio[:, :r * hop].reshape(c, r, hop)
                + shifted).reshape(c, r * hop)
        body_audio = jnp.concatenate([head, body_audio[:, r * hop:]],
                                     axis=-1)
        last_tail = jax.lax.psum(
            jnp.where(idx_dev == d - 1, tail, 0.0), axis)
        return body_audio, last_tail

    fn_sharded = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, None, axis), P(axis, None), P(axis, None),
                  P(axis, None, None), P(axis, None, None),
                  P(axis, None, None), P(axis, None)),
        out_specs=(P(None, axis), P(None, None, None)))
    audio, last_tail = fn_sharded(stacked, sp_dev, i0_dev, li_dev, mix_dev,
                                  valid_dev, f0_dev)
    stream = jnp.concatenate([audio, last_tail.reshape(c, r * hop)],
                             axis=-1)
    shift = window_size // 2
    return stream[:, shift:shift + out_frames * hop]


def stretch_sp_streamed(x: jnp.ndarray, mesh: Mesh, *, factor,
                        window_size: int = 2048, hop: int = 128,
                        dft_size: int = 4096, sample_rate: float = 48000.0,
                        axis: str = "sp", chunk_out: int = 256):
    """Sequence-parallel AND streamed PV time-stretch: the monotone
    time-map instantiation of streamed_sp_process (see there for the
    two-pass phase prefix and tail handoff design)."""
    from flan_tpu.func.function import as_function

    nh = num_hops(int(x.shape[-1]), hop)
    fn = as_function(factor)
    if fn.is_constant:
        factors = np.full(nh, float(fn.constant_value), np.float64)
    else:
        t = np.arange(nh, dtype=np.float64) * (hop / sample_rate)
        factors = np.asarray(fn(jnp.asarray(t, jnp.float32)),
                             np.float64).reshape(-1)
        factors = np.broadcast_to(factors, (nh,))
    if (factors <= 0).any():
        raise ValueError("stretch_sp_streamed requires positive factors")
    return streamed_sp_process(
        [x], mesh, None, time_map=np.cumsum(factors),
        window_size=window_size, hop=hop, dft_size=dft_size,
        sample_rate=sample_rate, axis=axis, chunk_out=chunk_out)


def repitch_sp_streamed(x: jnp.ndarray, mesh: Mesh, *, factor,
                        window_size: int = 2048, hop: int = 128,
                        dft_size: int = 4096, sample_rate: float = 48000.0,
                        axis: str = "sp", chunk_out: int = 256):
    """Sequence-parallel streamed PV repitch: per-frame monotonic
    frequency remap (reference PVModify.cpp:273-305) on an identity time
    map, sharded over the mesh with O(chunk) per-device HBM. Shares the
    chunk_op with the single-chip pipelines/streamed.pv_repitch_pipeline
    (value-equality asserted in __graft_entry__.dryrun_multichip)."""
    from flan_tpu.pipelines.streamed import _repitch_chunk_op

    chunk_op = _repitch_chunk_op(
        factor, dft_size // 2 + 1, sample_rate / dft_size,
        sample_rate / hop)
    return streamed_sp_process(
        [x], mesh, chunk_op, time_map=None, window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=sample_rate, axis=axis,
        chunk_out=chunk_out)


def morph_sp_streamed(a: jnp.ndarray, b: jnp.ndarray, mesh: Mesh, *,
                      amount, window_size: int = 2048, hop: int = 128,
                      dft_size: int = 4096, sample_rate: float = 48000.0,
                      axis: str = "sp", chunk_out: int = 256):
    """Sequence-parallel streamed two-source spectral morph
    (replace_amplitudes semantics, reference PV.cpp:205-236), sharded
    over the mesh with O(chunk) per-device HBM. Shares the chunk_op with
    pipelines/streamed.pv_morph_pipeline."""
    from flan_tpu.pipelines.streamed import _morph_chunk_op

    min_nh = min(num_hops(int(a.shape[-1]), hop),
                 num_hops(int(b.shape[-1]), hop))
    chunk_op = _morph_chunk_op(amount, min_nh, sample_rate / dft_size,
                               sample_rate / hop)
    return streamed_sp_process(
        [a, b], mesh, chunk_op, time_map=None, window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=sample_rate, axis=axis,
        chunk_out=chunk_out)


def stretch_sp(x: jnp.ndarray, mesh: Mesh, *, factor, window_size: int = 2048,
               hop: int = 128, dft_size: int = 4096,
               sample_rate: float = 48000.0, axis: str = "sp"):
    """Sequence-parallel PV time-stretch: audio [C, N] -> audio, end to end.

    The flagship pipeline sharded over a mesh.
    Work is sharded by OUTPUT hops: each device owns a contiguous span of
    stretched frames and, because the time map is monotonic, needs only a
    contiguous, host-precomputed range of input hops. Rather than resharding
    the 2x-overlap-factor-heavy PV tensors between devices, each device
    re-derives its own input PV frames from raw audio (one cheap all_gather:
    audio is window/hop * 2 = 32x smaller than PV data at default params,
    and halo hops are recomputed redundantly - compute is cheaper than the
    sparse all_to_all it replaces). Cross-device sequential state:

    * inverse phase accumulation: local mod-1 cycle prefix via the tiled
      matmul cumsum, then one all_gather of per-device totals;
    * overlap-add tail: ppermute to the right neighbor, as pv_inverse_sp.

    Matches Audio.convert_to_PV >> stretch >> convert_to_audio for monotonic
    maps (asserted in __graft_entry__.dryrun_multichip and
    tests/test_multichip.py).
    """
    from flan_tpu.func.function import as_function

    c, n = x.shape
    d = mesh.shape[axis]
    nh = num_hops(n, hop)
    analysis_rate = sample_rate / hop
    nbins = dft_size // 2 + 1

    # ---- host: sample the factor, build the monotone time map ----
    fn = as_function(factor)
    if fn.is_constant:
        factors = np.full(nh, float(fn.constant_value), np.float64)
    else:
        t = np.arange(nh, dtype=np.float64) * (hop / sample_rate)
        factors = np.asarray(fn(jnp.asarray(t, jnp.float32)),
                             np.float64).reshape(-1)
        factors = np.broadcast_to(factors, (nh,))
    if (factors <= 0).any():
        raise ValueError("stretch_sp requires positive factors")
    time_map = np.cumsum(factors)
    out_frames = int(math.ceil(time_map.max()))
    oh_local = _cdiv(out_frames, d)
    fpad = oh_local * d

    wpad = _cdiv(window_size, hop) * hop
    r = wpad // hop
    if oh_local < r:
        raise ValueError(
            "output shard shorter than the overlap-add tail; use fewer "
            "devices or longer audio")

    # ---- host: per-output-frame gather plan (monotone map inverts to a
    #      searchsorted gather; ops/pv_modify.py) ----
    xs = np.arange(fpad, dtype=np.float64)
    raw_idx = np.searchsorted(time_map, xs, side="right")
    valid = (raw_idx >= 1) & (raw_idx <= nh - 1) & (xs < out_frames)
    idx = np.clip(raw_idx, 1, nh - 1)
    l = time_map[idx - 1]
    rr = time_map[idx]
    mix = np.clip((xs - l) / np.where(rr == l, 1.0, rr - l), 0.0, 1.0)

    idx_s = idx.reshape(d, oh_local)
    lo = idx_s.min(axis=1) - 1                     # first needed input hop
    hi = idx_s.max(axis=1)                          # last needed input hop
    h_count = int((hi - lo).max()) + 2              # +1 pair, +1 helper hop
    li = (idx_s - 1 - lo[:, None]).astype(np.int32)  # local pair-low index

    # ---- device operands ----
    window = hann_window(window_size)
    bin_freq = (jnp.arange(nbins, dtype=jnp.float32)
                * (sample_rate / dft_size))
    expected = bin_freq / analysis_rate * (2.0 * jnp.pi)
    inv_scale = 2.67 / (dft_size * window_size / hop) * dft_size
    inv_window = jnp.zeros((wpad,), jnp.float32).at[:window_size].set(
        hann_window(window_size) * inv_scale)

    n_local = _cdiv(n, d)
    xp_in = jnp.pad(x, [(0, 0), (0, n_local * d - n)])
    left_pad = wpad + hop
    span_len = (h_count + r + 1) * hop
    H = h_count

    lo_dev = jnp.asarray(lo, jnp.int32)                      # [d]
    li_dev = jnp.asarray(li.reshape(fpad), jnp.int32)        # [fpad]
    mix_dev = jnp.asarray(mix, jnp.float32)                  # [fpad]
    valid_dev = jnp.asarray(valid)                           # [fpad]

    def kernel(x_local, lo_c, li_c, mix_c, valid_c):
        # ---- gather the full (small) audio once; pad for clean slices ----
        full = jax.lax.all_gather(x_local, axis, axis=1, tiled=True)
        xf = jnp.pad(full[:, :],
                     [(0, 0), (left_pad, span_len + left_pad)])
        # zero anything past the true signal end (the d-multiple padding)
        # is already zero from the host-side pad.
        s0 = (lo_c[0] - 1) * hop - window_size // 2 + left_pad
        span = jax.lax.dynamic_slice(xf, (0, s0), (c, span_len))

        # ---- forward PV on the local input-hop range ----
        rows = span.reshape(c, span_len // hop, hop)
        frames = jnp.stack(
            [rows[:, jj:jj + H, :] for jj in range(r)], axis=2)
        frames = frames.reshape(c, H, r * hop)[..., :window_size]
        # mask samples outside the true signal (mirrors pv_forward's
        # zero-padding; the left_pad region is already zero)
        starts = (lo_c[0] - 1 + jnp.arange(H)) * hop - window_size // 2
        gidx = starts[:, None] + jnp.arange(window_size)[None, :]
        frames = jnp.where(((gidx >= 0) & (gidx < n))[None], frames, 0.0)
        frames = frames * window[None, None, :]

        from flan_tpu.ops.stft import irfft_polar, rfft_mag_phase
        mag, phase = rfft_mag_phase(frames, dft_size)        # [C, H, B]
        prev = jnp.concatenate(
            [jnp.zeros((c, 1, nbins), jnp.float32), phase[:, :-1]], axis=1)
        hop_ids = lo_c[0] - 1 + jnp.arange(H)
        prev = jnp.where((hop_ids[None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, :])
        freq = bin_freq[None, None, :] + delta * (analysis_rate
                                                  / (2.0 * jnp.pi))
        mag = mag[:, 1:]          # drop the prev-phase helper hop
        freq = freq[:, 1:]

        # ---- local stretch gather (WFS policy, PVModify.cpp:344-355) ----
        w0 = (1.0 - mix_c)[None, :, None] * mag[:, li_c]
        w1 = mix_c[None, :, None] * mag[:, li_c + 1]
        total = w0 + w1
        fsum = w0 * freq[:, li_c] + w1 * freq[:, li_c + 1]
        v = valid_c[None, :, None]
        s_mag = jnp.where(v, total, 0.0)
        s_freq = jnp.where(v & (total > 0.0),
                           fsum / jnp.where(total > 0.0, total, 1.0), 0.0)

        # ---- inverse PV with cross-device phase prefix + OLA handoff ----
        idx_dev = jax.lax.axis_index(axis)
        inc = jnp.mod(s_freq / analysis_rate, 1.0)
        cycles = cumsum_mod1_frames(inc)
        totals = jax.lax.all_gather(cycles[:, -1, :], axis)   # [D, C, B]
        ranks = jnp.arange(d)[:, None, None]
        prefix = jnp.sum(jnp.where(ranks < idx_dev, totals, 0.0), axis=0)
        cycles = jnp.mod(cycles + jnp.mod(prefix, 1.0)[:, None, :], 1.0)

        out_t = irfft_polar(s_mag, cycles * (2.0 * jnp.pi),
                            dft_size)[..., :wpad]
        out_t = out_t * inv_window[None, None, :]
        blocks = out_t.reshape(c, oh_local, r, hop)
        acc = jnp.zeros((c, oh_local + r, hop), jnp.float32)
        for j in range(r):
            acc = acc.at[:, j:j + oh_local, :].add(blocks[:, :, j, :])
        tail = acc[:, oh_local:, :]
        shifted = jax.lax.ppermute(
            tail, axis, [(i, (i + 1) % d) for i in range(d)])
        shifted = jnp.where(idx_dev == 0, 0.0, shifted)
        acc = acc.at[:, :r, :].add(shifted)
        last_tail = jax.lax.psum(
            jnp.where(idx_dev == d - 1, tail, 0.0), axis)
        return (acc[:, :oh_local, :].reshape(c, oh_local * hop), last_tail)

    fn_sharded = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(None, axis), P(None, None, None)))
    audio, last_tail = fn_sharded(xp_in, lo_dev, li_dev, mix_dev, valid_dev)
    stream = jnp.concatenate(
        [audio, last_tail.reshape(c, r * hop)], axis=-1)
    shift = window_size // 2
    return stream[:, shift:shift + out_frames * hop]
