"""A/B: streamed scan vs materializing (batched, scan-free) PV stretch.

The headline ships the O(chunk)-memory streamed scan because 600 s stereo
materializes ~15 GB of PV planes. The materializing path is pure batched
tensor work — giant FFT batches, the matmul phase cumsum, one remap
gather — with no sequential carrier at all, so this measures how much
the scan itself costs: if the materializing form wins, the 600 s headline
could become a chain of materializing SEGMENTS with host-carried
phase/OLA boundaries instead of a scan (segment size bounded by device
memory).

Usage: python tools/ab_materializing.py streamed|materializing [SECONDS]
Prints one JSON line. Subprocess-isolate per arm.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    arm = sys.argv[1]
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 150.0

    import jax
    import jax.numpy as jnp
    from flan_tpu.ops import stft, pv_modify
    from flan_tpu.pipelines import pv_stretch_pipeline

    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray(np.stack([
        0.4 * np.sin(2 * np.pi * (220.0 + 10 * c) * t)
        + 0.1 * rng.standard_normal(n) for c in range(2)
    ]).astype(np.float32))

    hop, window_size, dft_size = 128, 2048, 4096
    factor = 2.0

    if arm == "streamed":
        fj = jax.jit(lambda v: pv_stretch_pipeline(
            v, factor, window_size=window_size, hop=hop, dft_size=dft_size,
            sample_rate=sr))
    else:
        nh = stft.num_hops(n, hop)
        out_frames = int(np.ceil(nh * factor))
        tm = jnp.cumsum(jnp.full((nh, 1), factor, jnp.float32), axis=0)

        def run_mat(v):
            mag, freq = stft.pv_forward(
                v, window_size=window_size, hop=hop, dft_size=dft_size,
                sample_rate=sr)
            s_mag, s_freq = pv_modify.modify_time_gather(
                mag, freq, tm, out_frames=out_frames)
            return stft.pv_inverse(s_mag, s_freq, window_size=window_size,
                                   hop=hop, sample_rate=sr)
        fj = jax.jit(run_mat)

    compiled = fj.lower(x).compile()
    ma = compiled.memory_analysis()

    def sync(y):
        jax.block_until_ready(y)

    sync(compiled(x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sync(compiled(x))
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "arm": arm, "seconds": seconds,
        "ms": round(best * 1e3, 1),
        "x_realtime": round(seconds / best, 1),
        "temp_gb": round(ma.temp_size_in_bytes / 2**30, 2)}))


if __name__ == "__main__":
    main()
