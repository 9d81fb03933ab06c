"""Fused streaming PV time-stretch: audio -> audio without materializing PV.

The unfused path (convert_to_PV -> stretch -> convert_to_audio)
materializes phase-vocoder data that is overlap-factor x 2 larger than the
audio: a 10-minute stereo 48 kHz file becomes ~15 GB of PV tensors (the
materializing path peaks at 38 GB on an 80 GB H100; the reference
materializes the same data in host RAM,
PVBuffer.h:27). This wrapper plans the monotonic time map on the host and
streams through the shared harness (pipelines/streamed.py): peak HBM is
O(chunk) regardless of file length; FLOPs are identical to the unfused
path. Numerically equivalent to
Audio.convert_to_PV().stretch(f).convert_to_audio() for monotonic maps
(validated in tests/test_pipeline.py).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from flan_tpu.ops.stft import num_hops
from flan_tpu.pipelines.streamed import streamed_pv_process


def pv_stretch_pipeline(x: jnp.ndarray, factor, *, window_size: int = 2048,
                        hop: int = 128, dft_size: int = 4096,
                        sample_rate: float = 48000.0,
                        chunk_out: int = None) -> jnp.ndarray:
    """Stream audio [C, N] through PV stretch by `factor` (positive float or
    Function of time returning positive factors)."""
    from flan_tpu.func.function import as_function
    c, n = x.shape
    nh = num_hops(n, hop)
    fn = as_function(factor)
    if fn.is_constant:
        factors = np.full(nh, fn.constant_value, np.float64)
    else:
        t = np.arange(nh, dtype=np.float64) * (hop / sample_rate)
        factors = np.asarray(fn(jnp.asarray(t, jnp.float32)),
                             np.float64).reshape(-1)
    if (factors <= 0).any():
        raise ValueError("stretch pipeline requires positive factors")
    time_map = np.cumsum(factors)

    return streamed_pv_process(
        [x], None, time_map=time_map, window_size=window_size, hop=hop,
        dft_size=dft_size, sample_rate=float(sample_rate),
        chunk_out=chunk_out)
