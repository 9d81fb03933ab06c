"""Generalized fused streaming PV pipeline: audio -> audio, O(chunk) HBM.

Factors the stretch pipeline (pipelines/stretch.py) into a reusable
harness: any chain of

    STFT forward -> [monotonic time remap] -> [per-chunk spectral op]
    -> STFT inverse

streams through one lax.scan without materializing full PV tensors
(overlap-factor x 2 larger than audio; ~15 GB for 10-min stereo at default
params; the unfused ops peak at 38 GB for it on an 80 GB card).
Carried state is the per-bin cycle offset and the overlap-add
tail; analysis frames are rebuilt per chunk from raw audio with one
dynamic_slice + static strided restacks.

Instantiations:
* pv_stretch_pipeline (pipelines/stretch.py) - time remap, no op
* pv_repitch_pipeline - identity map + per-frame frequency remap
  (reference PVModify.cpp:273-305)
* pv_morph_pipeline - identity map + two-source amplitude blend
  (reference PV.cpp:205-236, replace_amplitudes semantics)
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.ops.stft import _cdiv, _wrap_radians, num_hops
from flan_tpu.ops.windows import hann_window

# A/B escape hatch (tools/ab_remap.py): True forces the dynamic remap
# path even for constant-rate maps
_FORCE_DYNAMIC_REMAP = False

# A/B knob (tools/ab_superchunk.py): dtype for the remap-side spectral
# planes (mag and the per-bin frequency DEVIATION from bin center; the
# deviation form keeps bf16 quantization at ~0.4 Hz instead of the
# ~2^-9-relative error absolute frequencies would carry into the phase
# accumulator). None = f32 (shipped default). The cycle accumulation and
# the FFTs always stay f32.
_REMAP_DTYPE = None

# A/B knob: how analysis frames are rebuilt from the hop-blocked span
# ("stack": wblocks static slices restacked; "gather": one static-index
# take along the block axis).
_FRAMING_MODE = "stack"

# A/B knob: split the per-step synthesis irfft into this many sub-batches
# along the frame axis (within each _SYNTH_SPLIT sub-range).
_IRFFT_SPLIT = 1

# Split the whole remap -> spectral-op -> cumsum -> polar-irfft region
# into this many carried sub-ranges of the chunk's output frames, which
# bounds the region's live set (several [C, frames, 2049] f32 temps)
# inside a bigger scan step. 1 = off; whether it pays on the card is an
# open question.
_SYNTH_SPLIT = 1


@functools.partial(
    jax.jit,
    static_argnames=("chunk_op", "n_in", "window_size", "hop", "dft_size",
                     "sample_rate", "out_frames", "max_hops_per_chunk",
                     "chunk_out", "li_row", "mix_row"))
def _streamed_scan(xs, plan, mix_s, *, chunk_op, n_in,
                   window_size, hop, dft_size, sample_rate, out_frames,
                   max_hops_per_chunk, chunk_out, li_row=None,
                   mix_row=None):
    """xs: [n_in, C, N] stacked inputs (equal shape). The remap plan is
    computed host-side in numpy by streamed_pv_process (no device
    searchsorted) and arrives PACKED as one int32 array — every jit
    argument is its own host->device transfer for eager callers, so
    `plan` carries [nchunks, 1 + chunk (+ chunk)]:
    column 0 = i0, then the per-frame valid mask, then (dynamic-path
    only) the per-frame li indices; mix_s is the one f32 array (None on
    the static path). When every chunk shares one remap pattern
    (constant factor or identity maps — including the headline),
    li_row/mix_row carry it as STATIC tuples instead: the per-chunk
    remap gather then has compile-time indices, which XLA lowers to
    static slice/select networks instead of a dynamic gather."""
    _, c, n = xs.shape
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
    fpad = nchunks * chunk_out
    H = max_hops_per_chunk
    out_f0 = jnp.arange(nchunks, dtype=jnp.int32) * chunk_out
    uniform = li_row is not None
    if uniform:
        li_const = np.asarray(li_row, np.int32)          # [chunk_out]
        mix_const = jnp.asarray(np.asarray(mix_row, np.float32))
    i0 = plan[:, 0]
    valid_s = plan[:, 1:1 + chunk_out] != 0
    li_s = None if uniform else plan[:, 1 + chunk_out:]

    left_pad = wpad + hop
    span_len = (H + wblocks + 1) * hop
    right_pad = span_len + left_pad
    xp = jnp.pad(xs, [(0, 0), (0, 0), (left_pad, right_pad)])
    span_start = (i0 - 1) * hop - (window_size // 2) + left_pad  # >= 0

    def forward_chunk(x_all, s0, i0_c):
        """All inputs' PV frames for this chunk's input hops."""
        span = jax.lax.dynamic_slice(
            x_all, (0, 0, s0), (n_in, c, span_len))
        rows = span.reshape(n_in, c, span_len // hop, hop)
        if _FRAMING_MODE == "gather":
            idx = (np.arange(H)[:, None]
                   + np.arange(wblocks)[None, :])   # [H, wblocks] static
            frames = rows[:, :, jnp.asarray(idx), :]
        else:
            frames = jnp.stack(
                [rows[:, :, jj:jj + H, :] for jj in range(wblocks)],
                axis=3)                        # [n_in, C, H, wblocks, hop]
        frames = frames.reshape(n_in, c, H, wblocks * hop)[
            ..., :window_size]
        frames = frames * window[None, None, None, :]

        from flan_tpu.ops.stft import rfft_mag_phase
        mag, phase = rfft_mag_phase(frames, dft_size)  # [n_in, C, H, B]
        prev = jnp.concatenate(
            [jnp.zeros((n_in, c, 1, nbins), jnp.float32),
             phase[:, :, :-1]], axis=2)
        hop_ids = i0_c - 1 + jnp.arange(H)
        prev = jnp.where((hop_ids[None, None, :, None] - 1) < 0, 0.0, prev)
        delta = _wrap_radians(phase - prev - expected[None, None, None, :])
        freq = bin_freq[None, None, None, :] + delta * (
            analysis_rate / (2.0 * jnp.pi))
        return mag[:, :, 1:], freq[:, :, 1:]   # drop helper hop

    def body(carry, inputs):
        cycle0, tail = carry
        if uniform:
            s0, i0_c, valid_c, f0 = inputs
            li_c, mix_c = li_const, mix_const
        else:
            s0, i0_c, li_c, mix_c, valid_c, f0 = inputs

        mag, freq = forward_chunk(xp, s0, i0_c)
        if _REMAP_DTYPE is not None:
            # gather halved planes: magnitude + per-bin deviation from the
            # bin-center frequency (remap mixes hops of the SAME bin, so
            # the deviation is the only varying part and stays within
            # ±analysis_rate/2, where bf16 costs < 0.4 Hz)
            mag = mag.astype(_REMAP_DTYPE)
            freq = (freq - bin_freq[None, None, None, :]).astype(
                _REMAP_DTYPE)

        def synth_sub(li_c_i, mix_c_i, valid_c_i, f0_i, cycle_in):
            """Remap + spectral op + carried mod-1 cumsum + polar irfft
            for one sub-range of the chunk's output frames. The region's
            live set (several [C, frames, nbins] f32 temps) is what
            _SYNTH_SPLIT bounds."""
            # ---- monotonic remap (WFS policy, PVModify.cpp:344-355) ----
            w0 = (1.0 - mix_c_i)[None, None, :, None] * mag[:, :, li_c_i]
            w1 = mix_c_i[None, None, :, None] * mag[:, :, li_c_i + 1]
            total = (w0 + w1).astype(jnp.float32)
            fsum = (w0 * freq[:, :, li_c_i]
                    + w1 * freq[:, :, li_c_i + 1]).astype(jnp.float32)
            v = valid_c_i[None, None, :, None]
            s_mag = jnp.where(v, total, 0.0)
            s_freq = jnp.where(v & (total > 0.0),
                               fsum / jnp.where(total > 0.0, total, 1.0),
                               0.0)
            if _REMAP_DTYPE is not None:
                s_freq = jnp.where(v & (total > 0.0),
                                   s_freq + bin_freq[None, None, None, :],
                                   0.0)

            # ---- per-chunk spectral op ----
            if chunk_op is not None:
                s_mag, s_freq = chunk_op(s_mag, s_freq, f0_i)
            else:
                s_mag, s_freq = s_mag[0], s_freq[0]

            # ---- inverse PV (mod-1 cycle accumulation, carried) ----
            from flan_tpu.ops.stft import cumsum_mod1_frames, irfft_polar
            frames_i = s_mag.shape[1]
            inc = jnp.mod(s_freq / analysis_rate, 1.0)
            cycles = cumsum_mod1_frames(inc)
            cycles = jnp.mod(cycles + cycle_in[:, None, :], 1.0)
            if _IRFFT_SPLIT > 1 and frames_i % _IRFFT_SPLIT == 0:
                sub = frames_i // _IRFFT_SPLIT
                o_t = jnp.concatenate([
                    irfft_polar(s_mag[:, i * sub:(i + 1) * sub],
                                cycles[:, i * sub:(i + 1) * sub]
                                * (2.0 * jnp.pi),
                                dft_size)[..., :wpad]
                    for i in range(_IRFFT_SPLIT)], axis=1)
            else:
                o_t = irfft_polar(s_mag, cycles * (2.0 * jnp.pi),
                                  dft_size)[..., :wpad]
            return o_t * inv_window[None, None, :], cycles[:, -1, :]

        splits = (_SYNTH_SPLIT if _SYNTH_SPLIT > 1
                  and chunk_out % _SYNTH_SPLIT == 0 else 1)
        if splits == 1:
            out_t, cycle_last = synth_sub(li_c, mix_c, valid_c, f0, cycle0)
        else:
            sub_n = chunk_out // splits
            parts = []
            cyc = cycle0
            for i in range(splits):
                sl = slice(i * sub_n, (i + 1) * sub_n)
                o_t_i, cyc = synth_sub(li_c[sl], mix_c[sl], valid_c[sl],
                                       f0 + i * sub_n, cyc)
                parts.append(o_t_i)
            out_t = jnp.concatenate(parts, axis=1)
            cycle_last = cyc

        blocks = out_t.reshape(c, chunk_out, r, hop)
        acc = jnp.zeros((c, chunk_out + r, hop), jnp.float32)
        acc = acc.at[:, :r, :].set(tail)
        for j in range(r):
            acc = acc.at[:, j:j + chunk_out, :].add(blocks[:, :, j, :])
        out = acc[:, :chunk_out, :].reshape(c, chunk_out * hop)
        new_tail = acc[:, chunk_out:, :]
        return (cycle_last, new_tail), out

    init = (jnp.zeros((c, nbins), jnp.float32),
            jnp.zeros((c, r, hop), jnp.float32))
    xs_scan = ((span_start, i0, valid_s, out_f0) if uniform
               else (span_start, i0, li_s, mix_s, valid_s, out_f0))
    (_, tail), outs = jax.lax.scan(body, init, xs_scan)
    body_audio = outs.transpose(1, 0, 2).reshape(c, fpad * hop)
    audio = jnp.concatenate([body_audio, tail.reshape(c, r * hop)], axis=-1)
    shift = window_size // 2
    return audio[:, shift:shift + out_frames * hop]


def streamed_pv_process(xs: Sequence[jnp.ndarray],
                        chunk_op: Optional[Callable] = None, *,
                        time_map: Optional[np.ndarray] = None,
                        window_size: int = 2048, hop: int = 128,
                        dft_size: int = 4096,
                        sample_rate: float = 48000.0,
                        chunk_out: int = None) -> jnp.ndarray:
    """Stream inputs through forward PV -> remap -> op -> inverse PV.

    xs: list of [C, N] audio arrays (equal channel counts; shorter inputs
    are zero-padded to the longest). chunk_op(mags, freqs, frame0) takes
    stacked [n_in, C, chunk, B] remapped planes plus the chunk's first
    global output-frame index and returns one (mag, freq) pair
    [C, chunk, B]; None passes input 0 through. time_map: per-input-hop
    monotonic output positions in PV frames (float64 [nh]); None means
    identity (frame-aligned ops, exact pv_forward/pv_inverse alignment).
    """
    n = max(int(x.shape[-1]) for x in xs)
    c = int(xs[0].shape[0])
    for x in xs:
        if int(x.shape[0]) != c:
            raise ValueError("streamed_pv_process requires equal channels")
    if chunk_out is None:
        # the per-step working set scales with total folded channels, so
        # wide folds take the smaller chunk (tuned on the previous
        # accelerator; re-sweeping on the card is an open question)
        chunk_out = 128 if c * len(xs) >= 16 else 256
    stacked = jnp.stack(
        [jnp.pad(x, [(0, 0), (0, n - int(x.shape[-1]))]) for x in xs])
    nh = num_hops(n, hop)

    if time_map is None:
        # identity: output frame j = input hop j exactly. With
        # tm = [0, 1, ..., nh], searchsorted(j, right) = j+1, so the pair
        # is (j, j+1) with mix 0 - a weight-1 read of frame j; the extra
        # trailing map entry keeps frame nh-1 inside the valid interval
        # (hop nh reads zero-padded signal and is never selected).
        out_frames = nh
        chunk_out = min(chunk_out, max(out_frames, 1))
        tm = np.arange(nh + 1, dtype=np.float64)
        max_hops = chunk_out + 4
    else:
        tm = np.asarray(time_map, np.float64)
        out_frames = int(math.ceil(float(np.max(tm))))
        chunk_out = min(chunk_out, max(out_frames, 1))
        steps = np.diff(np.concatenate([[0.0], tm]))
        min_step = float(steps.min())
        if min_step <= 0:
            raise ValueError("time_map must be strictly increasing")
        max_hops = int(math.ceil(chunk_out / min_step)) + 4

    # host-side remap plan (f32 arithmetic, bit-matching the previous
    # in-jit form; device searchsorted is pathological on this backend)
    nchunks = _cdiv(out_frames, chunk_out)
    fpad = nchunks * chunk_out
    tm32 = tm.astype(np.float32)
    nt = tm32.shape[0]
    xs_idx = np.arange(fpad, dtype=np.float32)
    idx = np.clip(np.searchsorted(tm32, xs_idx, side="right"),
                  1, nt - 1).astype(np.int64)
    l = tm32[idx - 1]
    rr = tm32[idx]
    mix = np.clip((xs_idx - l) / np.where(rr == l,
                                          np.float32(1.0), rr - l),
                  np.float32(0.0), np.float32(1.0)).astype(np.float32)
    valid = ((xs_idx < out_frames) & (xs_idx >= tm32[0])
             & (xs_idx < tm32[nt - 1]))
    i0 = (idx.reshape(nchunks, chunk_out)[:, 0] - 1).astype(np.int32)
    li = np.clip(idx.reshape(nchunks, chunk_out) - 1
                 - i0[:, None].astype(np.int64),
                 0, max_hops - 3).astype(np.int32)
    mix_s = mix.reshape(nchunks, chunk_out)
    valid_s = valid.reshape(nchunks, chunk_out)

    # constant-rate maps (the headline stretch, identity repitch/morph)
    # repeat ONE remap pattern every chunk on their valid frames; pass it
    # as a static row so the per-chunk gather has compile-time indices.
    # Edge chunks (before tm[0] / past tm[-1]) have locally-shifted i0
    # from the idx clip, so the uniform stride is extended from a fully
    # valid interior chunk and li recomputed against it — selected hops
    # i0 + li are unchanged where valid, and invalid frames are masked
    # after the gather exactly as before.
    full = np.nonzero(valid_s.all(axis=1))[0]
    li_row = mix_row = None
    if not _FORCE_DYNAMIC_REMAP:
        # reference chunk: first fully valid one, else the most-valid
        # (single-chunk runs and edge-heavy maps have none fully valid;
        # the masked comparison below still decides correctly)
        ref = int(full[0]) if full.size else int(
            np.argmax(valid_s.sum(axis=1)))
        stride = (int(i0[ref + 1]) - int(i0[ref])
                  if ref + 1 < nchunks else 0)
        i0_u = (int(i0[ref])
                + (np.arange(nchunks, dtype=np.int64) - ref) * stride)
        li_u = np.clip(idx.reshape(nchunks, chunk_out) - 1
                       - i0_u[:, None], 0, max_hops - 3).astype(np.int32)
        wpad_ = _cdiv(window_size, hop) * hop
        span_ok = ((int(i0_u.min()) - 1) * hop - window_size // 2
                   + wpad_ + hop) >= 0
        same = span_ok and all(
            np.array_equal(li_u[k][valid_s[k]], li_u[ref][valid_s[k]])
            and np.array_equal(mix_s[k][valid_s[k]],
                               mix_s[ref][valid_s[k]])
            for k in range(nchunks))
        if same:
            li_row = tuple(int(v) for v in li_u[ref])
            mix_row = tuple(float(v) for v in mix_s[ref])
            i0 = i0_u.astype(np.int32)
    # pack the int32 plan pieces into ONE device transfer: every jit
    # argument is its own host->device transfer for eager callers
    if li_row is not None:
        plan = np.concatenate(
            [i0[:, None].astype(np.int32), valid_s.astype(np.int32)],
            axis=1)
        mix_arg = None
    else:
        plan = np.concatenate(
            [i0[:, None].astype(np.int32), valid_s.astype(np.int32), li],
            axis=1)
        mix_arg = jnp.asarray(mix_s)

    return _streamed_scan(
        stacked, jnp.asarray(plan.astype(np.int32)), mix_arg,
        chunk_op=chunk_op, n_in=len(xs), window_size=window_size, hop=hop,
        dft_size=dft_size, sample_rate=float(sample_rate),
        out_frames=out_frames, max_hops_per_chunk=max_hops,
        chunk_out=chunk_out, li_row=li_row, mix_row=mix_row)


def _memo_chunk_op(factory):
    """Memoize a chunk_op factory on its (hashable) arguments.

    chunk_op is a static jit argument of _streamed_scan, hashed by object
    identity - a fresh closure per pipeline call would retrace (and, cold,
    recompile) on EVERY call.
    Caching the closure on the user's control values restores the jit
    cache; unhashable controls (arrays) fall through uncached."""
    cached = functools.lru_cache(maxsize=64)(factory)

    @functools.wraps(factory)
    def get(*args):
        try:
            return cached(*args)
        except TypeError:       # unhashable control; caller pays retrace
            return factory(*args)
    return get


def pv_repitch_pipeline(x: jnp.ndarray, factor, *, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0,
                        chunk_out: int = None) -> jnp.ndarray:
    """Streaming audio -> audio PV repitch: per-frame monotonic frequency
    remap (reference PVModify.cpp:273-305) without materializing PV.
    factor: positive float or Function of (t, f)."""
    chunk_op = _repitch_chunk_op(
        factor, dft_size // 2 + 1, sample_rate / dft_size,
        sample_rate / hop)
    return streamed_pv_process(
        [x], chunk_op, time_map=None, window_size=window_size, hop=hop,
        dft_size=dft_size, sample_rate=sample_rate, chunk_out=chunk_out)


@_memo_chunk_op
def _repitch_chunk_op(factor, nbins, bin_width, analysis_rate):
    from flan_tpu.func.function import as_function2d
    from flan_tpu.ops.pv_modify import modify_frequency_gather

    fn = as_function2d(factor)
    if fn.is_constant:
        return _repitch_chunk_op_const(float(fn.constant_value), nbins,
                                       bin_width)

    def chunk_op(mags, freqs, f0):
        mag, freq = mags[0], freqs[0]
        c, chunk, b = mag.shape
        t = (f0 + jnp.arange(chunk, dtype=jnp.float32)) / analysis_rate
        fr = jnp.arange(b, dtype=jnp.float32) * bin_width
        sampled = jnp.broadcast_to(fn(t[:, None], fr[None, :]), (chunk, b))
        bin_map = jnp.cumsum(sampled, axis=1)
        freq_map_hz = bin_map * bin_width
        fbin = jnp.clip(freq / bin_width, 0.0, b - 1 - 1e-4)
        lo = jnp.floor(fbin).astype(jnp.int32)
        rmix = fbin - lo
        lo_val = jnp.take_along_axis(freq_map_hz[None],
                                     lo.reshape(c, chunk, -1), axis=2)
        hi_val = jnp.take_along_axis(freq_map_hz[None],
                                     (lo + 1).reshape(c, chunk, -1), axis=2)
        freq_modified = lo_val * (1 - rmix) + hi_val * rmix
        return modify_frequency_gather(mag, freq_modified, bin_map)

    return chunk_op


def _repitch_chunk_op_const(f: float, nbins: int, bin_width: float):
    """Constant-factor repitch chunk op: the host-precomputed inverse bin
    map (ops/pv_modify.modify_frequency_gather_const) replaces the general
    path's per-chunk searchsorted + data-dependent gathers with
    static-permutation work."""
    from flan_tpu.ops.pv_modify import modify_frequency_gather_const

    def chunk_op(mags, freqs, f0):
        return modify_frequency_gather_const(mags[0], freqs[0], f,
                                             bin_width)

    return chunk_op


def pv_morph_pipeline(a: jnp.ndarray, b: jnp.ndarray, amount, *,
                      window_size: int = 2048, hop: int = 128,
                      dft_size: int = 4096, sample_rate: float = 48000.0,
                      chunk_out: int = None) -> jnp.ndarray:
    """Streaming two-source spectral morph: replace_amplitudes semantics
    (reference PV.cpp:205-236) - magnitudes blend toward source b by
    amount(t, f), frequencies stay a's - fused end to end so 10-minute
    inputs never materialize PV tensors."""
    # replace_amplitudes zero-fills beyond the shorter source's frames
    # (pv/algorithms.py replace_amplitudes: out planes start at zero and
    # only [:min_frames] is written) - mirror that here, where the harness
    # zero-pads the shorter input instead of truncating
    min_nh = min(num_hops(int(a.shape[-1]), hop),
                 num_hops(int(b.shape[-1]), hop))
    chunk_op = _morph_chunk_op(amount, min_nh, sample_rate / dft_size,
                               sample_rate / hop)
    return streamed_pv_process(
        [a, b], chunk_op, time_map=None, window_size=window_size, hop=hop,
        dft_size=dft_size, sample_rate=sample_rate, chunk_out=chunk_out)


@_memo_chunk_op
def _morph_chunk_op(amount, min_nh, bin_width, analysis_rate):
    from flan_tpu.func.function import as_function2d

    fn = as_function2d(amount)

    def chunk_op(mags, freqs, f0):
        c, chunk, nb = mags[0].shape
        frame_ids = f0 + jnp.arange(chunk, dtype=jnp.float32)
        t = frame_ids / analysis_rate
        fr = jnp.arange(nb, dtype=jnp.float32) * bin_width
        amt = jnp.clip(
            jnp.broadcast_to(fn(t[:, None], fr[None, :]), (chunk, nb)),
            0.0, 1.0)
        mag = mags[1] * amt[None] + mags[0] * (1.0 - amt)[None]
        live = (frame_ids < min_nh)[None, :, None]
        return jnp.where(live, mag, 0.0), jnp.where(live, freqs[0], 0.0)

    return chunk_op
