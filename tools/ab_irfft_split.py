"""A/B: chunk size x synthesis-region split for the headline stretch.

Round-5 stage ablation (tools/profile_headline_stages.py at chunk 512)
localizes the >256 chunk cliff; if the culprit is the synthesis irfft
custom call (its input crosses ~16 MB right above 2ch x 512 x 4096),
splitting the per-step irfft into sub-batches (_IRFFT_SPLIT) should
restore the per-call FFT size while keeping the halved step count —
the first candidate fix that could unlock chunk >= 384.

Usage: python tools/ab_irfft_split.py CHUNK SYNTH_SPLIT [IRFFT_SPLIT] [SECONDS]
Prints one JSON line. Subprocess-isolate per arm.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    chunk = int(sys.argv[1])
    split = int(sys.argv[2])
    irfft_split = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    seconds = float(sys.argv[4]) if len(sys.argv) > 4 else 150.0

    import jax
    import jax.numpy as jnp
    import flan_tpu.pipelines.streamed as st
    st._SYNTH_SPLIT = split
    st._IRFFT_SPLIT = irfft_split
    from flan_tpu.pipelines import pv_stretch_pipeline

    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    x = jnp.asarray(np.stack([
        0.4 * np.sin(2 * np.pi * (220.0 + 10 * c) * t)
        + 0.1 * rng.standard_normal(n) for c in range(2)
    ]).astype(np.float32))

    fj = jax.jit(lambda v: pv_stretch_pipeline(
        v, 2.0, window_size=2048, hop=128, dft_size=4096,
        sample_rate=sr, chunk_out=chunk))
    compiled = fj.lower(x).compile()

    def sync(y):
        jax.block_until_ready(y)

    sync(compiled(x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sync(compiled(x))
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "chunk": chunk, "synth_split": split, "irfft_split": irfft_split,
        "seconds": seconds,
        "ms": round(best * 1e3, 1),
        "x_realtime": round(seconds / best, 1)}))


if __name__ == "__main__":
    main()
