"""PV time/frequency remap kernels.

JAX re-design of the reference's scatter-paint remaps
(reference: src/flan/PV/PVModify.cpp:196-385). The reference walks adjacent
input frame (or bin) pairs and paints every integer output cell in the mapped
interval, synchronizing with mutexes. For monotonic maps (every stretch /
repitch with positive factor) the painted intervals exactly partition the
output axis, so the scatter inverts into a pure gather: one searchsorted per
output cell plus a weighted read of the surrounding input pair. No mutexes,
no atomics, and the memory access pattern is dense and XLA-fusable.

Write policies preserved from the reference:
* modify_time (PVModify.cpp:307-362): weighted-frequency-sum - magnitude is
  the interpolation weight sum, frequency the weighted average.
* modify_frequency (PVModify.cpp:196-257): max-weight select - the louder
  weighted endpoint's (magnitude, modified frequency) is written.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func import interpolators


def _pair_lookup(map_1d: jnp.ndarray, xs: jnp.ndarray):
    """For each x, find pair index i with map[i-1] <= x < map[i].

    Returns (idx, valid). map_1d must be non-decreasing ([F] float32).

    method="sort": chosen over the default binary-search lowering on the
    previous accelerator; which lowering is faster on the card is an open
    question. Monotone-map callers with host-known maps should
    precompute indices instead (see pipelines/streamed.py and the
    constant-factor repitch path).
    """
    idx = jnp.searchsorted(map_1d, xs, side="right", method="sort")
    valid = (idx >= 1) & (idx <= map_1d.shape[0] - 1)
    return jnp.clip(idx, 1, map_1d.shape[0] - 1), valid


@functools.partial(jax.jit, static_argnames=("out_frames", "interp"))
def modify_time_gather(mag: jnp.ndarray, freq: jnp.ndarray,
                       time_map: jnp.ndarray, *, out_frames: int,
                       interp: Callable = interpolators.linear):
    """Monotonic time remap (stretch / modify_time fast path).

    mag, freq: [C, F, B]. time_map: [F, B] (or [F, 1]) giving, per input
    frame, the mapped output position in PV frames (monotonic in F).
    Output: (mag, freq) [C, out_frames, B] with the reference's
    weighted-frequency-sum policy (PVModify.cpp:344-355).
    """
    c, f, b = mag.shape
    xs = jnp.arange(out_frames, dtype=jnp.float32)

    # searchsorted per bin: time_map [F, Bm] -> idx [Bm, X]
    idx, valid = jax.vmap(_pair_lookup, in_axes=(1, None))(time_map, xs)
    bm = time_map.shape[1]

    def _zero_abort(l, r, m_l, m_r):
        """Reference zero-abort quirk (PVModify.cpp:350-351): the spread
        loop RETURNS at the first x whose totalWeight == 0, leaving the
        rest of the pair span unwritten. For linear-family interps
        (interp(0)==0) and non-negative magnitudes the blend is monotone in
        x, so weight 0 can only occur at the first tested x = max(ceil(l),
        0) - the whole span is killed iff the weight there is 0."""
        fx = jnp.maximum(jnp.ceil(l), 0.0)
        mix0 = interp(jnp.clip((fx - l) / jnp.where(r == l, 1.0, r - l),
                               0.0, 1.0))
        return (1.0 - mix0) * m_l + mix0 * m_r == 0.0

    def gather_bin(map_col, idx_col, valid_col, mag_cb, freq_cb):
        # map_col [F], idx_col [X], mag_cb/freq_cb [C, F]
        l = map_col[idx_col - 1]
        r = map_col[idx_col]
        mix = interp(jnp.clip((xs - l) / jnp.where(r == l, 1.0, r - l),
                              0.0, 1.0))
        m_l = mag_cb[:, idx_col - 1]
        m_r = mag_cb[:, idx_col]
        w0 = (1.0 - mix)[None, :] * m_l
        w1 = mix[None, :] * m_r
        total = w0 + w1
        fsum = w0 * freq_cb[:, idx_col - 1] + w1 * freq_cb[:, idx_col]
        live = valid_col[None, :] & ~_zero_abort(l, r, m_l, m_r)
        out_m = jnp.where(live, total, 0.0)
        out_f = jnp.where(live & (total > 0.0),
                          fsum / jnp.where(total > 0.0, total, 1.0), 0.0)
        return out_m, out_f  # [C, X]

    if bm == 1:
        # shared map across bins: single lookup, gather over all bins at once
        l = time_map[idx[0] - 1, 0]
        r = time_map[idx[0], 0]
        mix = interp(jnp.clip((xs - l) / jnp.where(r == l, 1.0, r - l),
                              0.0, 1.0))
        i0 = idx[0] - 1
        i1 = idx[0]
        m_l = mag[:, i0, :]
        m_r = mag[:, i1, :]
        w0 = (1.0 - mix)[None, :, None] * m_l
        w1 = mix[None, :, None] * m_r
        total = w0 + w1
        fsum = w0 * freq[:, i0, :] + w1 * freq[:, i1, :]
        live = valid[0][None, :, None] & ~_zero_abort(
            l[None, :, None], r[None, :, None], m_l, m_r)
        out_mag = jnp.where(live, total, 0.0)
        out_freq = jnp.where(live & (total > 0.0),
                             fsum / jnp.where(total > 0.0, total, 1.0), 0.0)
        return out_mag, out_freq

    # bin-dependent map: vmap over bins
    def per_bin(map_col, idx_col, valid_col, mag_b, freq_b):
        # mag_b/freq_b: [C, F]
        return gather_bin(map_col, idx_col, valid_col, mag_b, freq_b)

    out_m, out_f = jax.vmap(per_bin, in_axes=(1, 0, 0, 2, 2),
                            out_axes=(2, 2))(time_map, idx, valid, mag, freq)
    return out_m, out_f


@functools.partial(jax.jit, static_argnames=("factor", "bin_width"))
def modify_frequency_gather_const(mag: jnp.ndarray, freq: jnp.ndarray,
                                  factor: float, bin_width: float):
    """Constant-factor frequency remap with the inverse bin map
    precomputed on the host (the common repitch(const) call).

    bin_map[j] = factor*(j+1) is known at trace time, so the pair
    indices/mixes/validity are numpy constants, the gathers compile to
    static lane permutations, and the per-MF frequency remap collapses to
    factor * (clip(freq) + bin_width) - the reference's +1-bin offset
    (PVModify.cpp:263-268, 287-302), which the general path's cumsum
    produces too. This replaces a per-chunk searchsorted + gather stage
    with elementwise work.
    """
    b = mag.shape[-1]
    f32 = np.float32(factor)
    bin_map = f32 * np.arange(1, b + 1, dtype=np.float32)
    ys = np.arange(b, dtype=np.float32)
    idx = np.searchsorted(bin_map, ys, side="right")
    valid = (idx >= 1) & (idx <= b - 1)
    idx = np.clip(idx, 1, b - 1)
    lo = bin_map[idx - 1]
    hi = bin_map[idx]
    mix = np.clip((ys - lo) / np.where(hi == lo, 1.0, hi - lo), 0.0, 1.0)
    mix_j = jnp.asarray(mix.astype(np.float32))
    idx_lo = idx - 1                     # python ints -> static gathers
    clamp_hi = (b - 1 - 1e-4) * bin_width

    # end-clamp quirk: end_bin = clamp(ceil(hiBin), 0, B-1) with a y != end
    # loop means the TOP bin is never written in forward mode
    # (PVModify.cpp:224-230); golden-verified in tests/test_algo_golden.py.
    valid &= ys < b - 1

    freq_mod = f32 * (jnp.clip(freq, 0.0, clamp_hi) + np.float32(bin_width))
    m_lo = mag[..., idx_lo]
    m_hi = mag[..., idx]
    w0 = (1.0 - mix_j) * m_lo
    w1 = mix_j * m_hi
    # the reference's ternary is INVERTED vs its own MIMM comment: w0 < w1
    # picks loMF (PVModify.cpp:237), i.e. the SMALLER-weight endpoint wins.
    # Golden-verified against the compiled reference; preserved bug-for-bug.
    pick_lo = w0 < w1
    out_m = jnp.where(pick_lo, m_lo, m_hi)
    out_f = jnp.where(pick_lo, freq_mod[..., idx_lo], freq_mod[..., idx])
    # a write only happens when the picked endpoint magnitude beats the
    # (zero-initialized) output: m must be strictly positive
    live = jnp.asarray(valid)[None] & (out_m > 0.0)
    return (jnp.where(live, out_m, 0.0), jnp.where(live, out_f, 0.0))


@functools.partial(jax.jit, static_argnames=("interp",))
def modify_frequency_gather(mag: jnp.ndarray, freq_modified: jnp.ndarray,
                            bin_map: jnp.ndarray, *,
                            interp: Callable = interpolators.linear):
    """Monotonic frequency remap (repitch / modify_frequency fast path).

    mag: [C, F, B] input magnitudes. freq_modified: [C, F, B] the mod
    function applied to each MF's own frequency (reference
    PVModify.cpp:263-268). bin_map: [F, B] mapped position of each bin in
    output-bin units (monotonic in B per frame). Output mag/freq [C, F, B]
    using the reference's max-weight endpoint policy (PVModify.cpp:230-243).
    """
    c, f, b = mag.shape
    ys = jnp.arange(b, dtype=jnp.float32)

    idx, valid = jax.vmap(_pair_lookup, in_axes=(0, None))(bin_map, ys)
    # idx, valid: [F, B_out]

    frame_ix = jnp.arange(f)[:, None]
    lo = bin_map[frame_ix, idx - 1]     # [F, B_out]
    hi = bin_map[frame_ix, idx]
    mix = interp(jnp.clip((ys[None, :] - lo)
                          / jnp.where(hi == lo, 1.0, hi - lo), 0.0, 1.0))

    m_lo = jnp.take_along_axis(mag, (idx - 1)[None], axis=2)
    m_hi = jnp.take_along_axis(mag, idx[None], axis=2)
    f_lo = jnp.take_along_axis(freq_modified, (idx - 1)[None], axis=2)
    f_hi = jnp.take_along_axis(freq_modified, idx[None], axis=2)

    w0 = (1.0 - mix)[None] * m_lo
    w1 = mix[None] * m_hi
    # INVERTED ternary quirk: the reference picks loMF when w0 < w1
    # (PVModify.cpp:237, the smaller-weight endpoint) - preserved
    # bug-for-bug, golden-verified in tests/test_algo_golden.py.
    pick_lo = w0 < w1
    out_m = jnp.where(pick_lo, m_lo, m_hi)
    out_f = jnp.where(pick_lo, f_lo, f_hi)
    # end-clamp quirk: the top bin is never written in forward mode
    # (end_bin clamps to B-1 and the loop is y != end, PVModify.cpp:224-230)
    # and a write requires the picked magnitude to beat the zero init.
    v = valid[None] & (ys < b - 1)[None] & (out_m > 0.0)
    return jnp.where(v, out_m, 0.0), jnp.where(v, out_f, 0.0)
