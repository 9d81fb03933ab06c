"""A/B the streamed stretch remap: static row vs dynamic gather.

Usage: python tools/ab_remap.py static|dynamic [SECONDS] [CHUNK_OUT] [CHANNELS]
Times the REAL pv_stretch_pipeline (factor 2, headline params) on the
current backend. Subprocess-isolate per arm.
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
    chunk_out = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    channels = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    import jax
    import jax.numpy as jnp
    import flan_tpu.pipelines.streamed as st
    if arm == "dynamic":
        st._FORCE_DYNAMIC_REMAP = True
    from flan_tpu.pipelines import pv_stretch_pipeline

    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray(np.stack([
        0.4 * np.sin(2 * np.pi * (220.0 + 10 * c) * t)
        + 0.1 * rng.standard_normal(n) for c in range(channels)
    ]).astype(np.float32))

    fj = jax.jit(lambda v: pv_stretch_pipeline(
        v, 2.0, window_size=2048, hop=128, dft_size=4096,
        sample_rate=48000.0, chunk_out=chunk_out))
    compiled = fj.lower(x).compile()

    def sync(y):
        jax.block_until_ready(y)

    sync(compiled(x))
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        sync(compiled(x))
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({"arm": arm, "seconds": seconds,
                      "chunk_out": chunk_out, "channels": channels,
                      "ms": round(best * 1e3, 1),
                      "x_realtime": round(seconds / best, 1)}))


if __name__ == "__main__":
    main()
