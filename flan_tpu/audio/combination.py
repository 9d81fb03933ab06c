"""Audio combination: mix, join, select, convolve.

JAX re-design of the reference's combination family
(reference: src/flan/Audio/AudioCombination.cpp). mix is the universal
combiner (join/select route through it). Attached to Audio in
flan_tpu.audio.__init__.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import as_function
from flan_tpu.ops import resample as resample_ops


def _match_sample_rates(ins: Sequence) -> List:
    """Resample all inputs to the highest rate if mixed
    (reference AudioCombination.cpp:17-35)."""
    max_sr = max(a.sample_rate for a in ins)
    return [a if a.sample_rate == max_sr else a.resample(max_sr)
            for a in ins]


def mix(ins: Sequence, start_times: Optional[Sequence[float]] = None,
        gains: Optional[Sequence] = None):
    """Sum inputs at offsets with per-input gain functions
    (reference AudioCombination.cpp:102-170). Gains are functions of
    global time. Fewer inputs than gains/times loops inputs cyclically."""
    from flan_tpu.audio.audio import Audio
    ins = [a for a in ins]
    if not ins:
        return Audio.create_null()
    start_times = list(start_times) if start_times else []
    gains = list(gains) if gains else []
    num_sources = max(len(ins), len(start_times), len(gains))

    ins = _match_sample_rates(ins)
    initial = len(ins)
    for i in range(initial, num_sources):
        ins.append(ins[i % initial])
    while len(start_times) < num_sources:
        start_times.append(0.0)

    sr = ins[0].sample_rate
    start_frames = [int(round(t * sr)) for t in start_times]
    num_channels = max(a.num_channels for a in ins)
    num_frames = max(max(0, a.num_frames + s)
                     for a, s in zip(ins, start_frames))
    out = jnp.zeros((num_channels, num_frames), jnp.float32)

    for i, (a, s) in enumerate(zip(ins, start_frames)):
        g = as_function(gains[i]) if i < len(gains) else as_function(1.0)
        if g.is_constant:
            contrib = a.data * g.constant_value
        else:
            # gain evaluated at global time over the input's span
            # (AudioCombination.cpp:134-139)
            t = (jnp.arange(a.num_frames, dtype=jnp.float32) + s) / sr
            contrib = a.data * jnp.broadcast_to(
                jnp.asarray(g(t), jnp.float32), (a.num_frames,))[None, :]
        # clip to output bounds
        lo = max(0, s)
        hi = min(num_frames, s + a.num_frames)
        if hi <= lo:
            continue
        out = out.at[:a.num_channels, lo:hi].add(
            contrib[:, lo - s:hi - s])
    return Audio(data=out, sample_rate=sr)


def join(ins: Sequence, offset: float = 0.0,
         offsets: Optional[Sequence[float]] = None):
    """Concatenate tip-to-tail with optional overlaps
    (reference AudioCombination.cpp:205-237). `offsets` takes len(ins)+1
    entries like the reference; scalar `offset` applies between all."""
    from flan_tpu.audio.audio import Audio
    ins = [a for a in ins if not a.is_null()]
    if not ins:
        return Audio.create_null()
    if offsets is None:
        offsets = [offset] * (len(ins) + 1)
    if len(offsets) != len(ins) + 1:
        return Audio.create_null()
    start_times = [0.0]
    for i in range(len(ins) - 1):
        start_times.append(start_times[-1] + ins[i].length + offsets[i + 1])
    return mix(ins, start_times)


def select(ins: Sequence, selection,
           start_times: Optional[Sequence[float]] = None):
    """Crossfade between streams by selection index
    (reference AudioCombination.cpp:239-258): balance_i(t) =
    sqrt(1 - |selection(t) - i|) within distance 1."""
    sel = as_function(selection)
    gains = []
    for i in range(len(ins)):
        def balance(t, i=i):
            d = jnp.abs(jnp.asarray(sel(t), jnp.float32) - i)
            return jnp.where(d >= 1.0, 0.0, jnp.sqrt(
                jnp.maximum(1.0 - d, 0.0)))
        gains.append(balance)
    return mix(ins, start_times, gains)


@functools.partial(jax.jit, static_argnames=("out_frames", "normalize"))
def _convolve_core(x, ir_mat, *, out_frames: int, normalize: bool):
    """One compiled program for the whole convolve (overlap-save FFT
    blocks + peak normalize): eager composition would dispatch each of
    its ~100 primitives separately."""
    from flan_tpu.ops.fft_conv import fft_convolve_full
    conv = fft_convolve_full(x, ir_mat)
    conv = jnp.pad(conv, [(0, 0), (0, out_frames - conv.shape[-1])]) \
        if conv.shape[-1] < out_frames else conv[:, :out_frames]
    conv = conv.astype(jnp.float32)
    if normalize:
        peak = jnp.max(jnp.abs(conv))
        conv = conv / jnp.where(peak > 0, peak, 1.0)
    return conv


def convolve(self, ir, normalize: bool = True):
    """Full FFT convolution (reference AudioCombination.cpp:299-353).
    IR channels are used cyclically on channel-count mismatch."""
    from flan_tpu.audio.audio import Audio
    if self.is_null() or ir.is_null():
        return Audio.create_null()
    if ir.sample_rate != self.sample_rate:
        ir = ir.resample(self.sample_rate)
    n, m = self.num_frames, ir.num_frames
    out_frames = n + m

    ir_rows = [ir.data[c % ir.num_channels]
               for c in range(self.num_channels)]
    ir_mat = jnp.stack(ir_rows)
    conv = _convolve_core(self.data, ir_mat, out_frames=out_frames,
                          normalize=bool(normalize))
    return Audio(data=conv, sample_rate=self.sample_rate)
