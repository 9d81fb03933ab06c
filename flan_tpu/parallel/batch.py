"""Data-parallel batch processing of audio clips over a device mesh.

The reference processes one buffer per call on host threads
(src/flan/Utility/execution.h); the device equivalent is throughput
batching: stack many clips, shard the batch axis across the mesh, and run
one jitted, vmapped transform - XLA partitions the whole program with zero
collectives (each device owns whole clips), so scaling is linear in chips.

Used for the production "render a playlist / dataset" shape of work where
sequence parallelism (stft_sp) is unnecessary because there are more files
than chips.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from flan_tpu.parallel.mesh import batch_sharding, make_mesh


def map_sharded(fn: Callable, clips: Sequence[jnp.ndarray],
                mesh: Optional[Mesh] = None) -> list:
    """Apply a jittable [C, N] -> [...] transform to every clip, with the
    batch sharded across the mesh.

    clips: equal-channel [C, N] arrays; shorter clips are zero-padded to
    the longest (callers slice results back if length matters). The batch
    is padded to a multiple of the mesh size with zeros and the padding
    results are dropped. Returns a list of per-clip outputs.
    """
    if not clips:
        return []
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    c = int(clips[0].shape[0])
    n = max(int(x.shape[-1]) for x in clips)
    for x in clips:
        if int(x.shape[0]) != c:
            raise ValueError("map_sharded requires equal channel counts")
    batch = len(clips)
    bpad = -(-batch // n_dev) * n_dev
    stacked = jnp.stack(
        [jnp.pad(jnp.asarray(x, jnp.float32),
                 [(0, 0), (0, n - int(x.shape[-1]))])
         for x in clips]
        + [jnp.zeros((c, n), jnp.float32)] * (bpad - batch))
    stacked = jax.device_put(
        stacked, batch_sharding(mesh, axis_name=mesh.axis_names[0]))
    out = _jitted_vmap(fn)(stacked)
    return [out[i] for i in range(batch)]


@functools.lru_cache(maxsize=64)
def _jitted_vmap(fn: Callable):
    """jit(vmap(fn)) cached on the transform object: a fresh jit wrapper
    per call would retrace every map_sharded invocation. Callers reusing the same
    function object across batches hit the jit cache."""
    return jax.jit(jax.vmap(fn))


def stretch_batch(clips: Sequence[jnp.ndarray], factor: float, *,
                  mesh: Optional[Mesh] = None, window_size: int = 2048,
                  hop: int = 128, dft_size: int = 4096,
                  sample_rate: float = 48000.0) -> list:
    """Data-parallel fused PV stretch of a batch of clips: the flagship
    pipeline vmapped over the sharded batch axis."""
    fn = _stretch_fn(float(factor), window_size, hop, dft_size,
                     float(sample_rate))
    return map_sharded(fn, clips, mesh=mesh)


@functools.lru_cache(maxsize=64)
def _stretch_fn(factor, window_size, hop, dft_size, sample_rate):
    """Per-parameter stretch closure, cached so repeated stretch_batch
    calls with equal parameters reuse one function object (and therefore
    one _jitted_vmap compile)."""
    from flan_tpu.pipelines import pv_stretch_pipeline

    return functools.partial(
        pv_stretch_pipeline, factor=factor, window_size=window_size,
        hop=hop, dft_size=dft_size, sample_rate=sample_rate)
