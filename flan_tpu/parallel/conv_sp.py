"""Sequence-parallel FFT convolution: the time-domain halo-exchange demo.

The reference's convolution is one giant single-process FFTW transform
(reference: src/flan/Audio/AudioCombination.cpp:299-353). Sharded over a
device mesh the natural decomposition is overlap-add across shards: each
device convolves its local time slice with the (replicated) impulse
response, and the L-1-sample tail that spills past the shard boundary is
handed to the right neighbor with one non-cyclic ppermute — the
time-domain analog of the analysis-window halo in stft_sp. Inside each
shard the overlap-save core (ops/fft_conv.fft_convolve_full) does the
work, so the single-chip fast path and the sharded path share one kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from flan_tpu.ops.fft_conv import fft_convolve_full


def convolve_sp(x: jnp.ndarray, h: jnp.ndarray, mesh: Mesh,
                axis: str = "sp") -> jnp.ndarray:
    """Full linear convolution [C, n] conv [C, m] -> [C, n + m - 1],
    time-sharded over mesh[axis].

    Matches fft_convolve_full's output convention (the caller applies
    flan's 1/sqrt(n) normalization, audio/combination.py convolve).
    Requires m - 1 <= ceil(n / d): the spill tail must fit in one
    neighbor shard so a single ppermute carries the whole halo.
    """
    c, n = x.shape
    if h.shape[0] != c:
        raise ValueError(f"channel mismatch: {x.shape} conv {h.shape}")
    m = h.shape[-1]
    d = mesh.shape[axis]
    s = -(-n // d)                      # local shard length
    if m - 1 > s:
        raise ValueError(
            f"impulse response tail {m - 1} exceeds the {s}-sample shard; "
            "use fewer devices or a shorter response")
    xp = jnp.pad(x, [(0, 0), (0, s * d - n)])

    def kernel(x_local, h_l):
        idx = jax.lax.axis_index(axis)
        y = fft_convolve_full(x_local, h_l)       # [C, s + m - 1]
        main, tail = y[:, :s], y[:, s:]
        # hand the spill tail to the right neighbor; device 0 receives
        # zeros (non-cyclic permute: absent sources yield zero)
        prev = jax.lax.ppermute(tail, axis,
                                [(i, i + 1) for i in range(d - 1)])
        main = main.at[:, : m - 1].add(prev)
        # the last device's tail is the final m-1 output samples; psum of
        # the masked value replicates it so out_specs can be unsharded
        last = jax.lax.psum(
            jnp.where(idx == d - 1, tail, jnp.zeros_like(tail)), axis)
        return main, last

    fn = shard_map(kernel, mesh=mesh,
                   in_specs=(P(None, axis), P(None, None)),
                   out_specs=(P(None, axis), P(None, None)))
    main, last = fn(xp, h)
    full = jnp.concatenate([main, last], axis=-1)
    return full[:, : n + m - 1]
