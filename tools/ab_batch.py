"""A/B the 16-clip batch config: channel-fold width x chunk sweep.

Usage: python tools/ab_batch.py FOLD [CHUNK_OUT] [NCLIPS] [CLIP_SECONDS]

Folds FOLD stereo clips into one [FOLD*2, n] program (every pipeline op
batches over channels natively) and dispatches NCLIPS/FOLD sequential
calls of the same compiled program - per-call carries reset naturally, so
results are per-clip exact. Inputs are pre-staged on device (the
host->device transfer is not part of the steady-state batch cost).
Prints one JSON line with the aggregate x-realtime over all NCLIPS clips.

Wide folds amortize the per-step scan overhead but grow every step's
working set; narrow folds pay overhead per step. The optimum is what
bench_batch should ship.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    fold = int(sys.argv[1])
    chunk_out = int(sys.argv[2]) if len(sys.argv) > 2 else None
    nclips = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    clip_seconds = float(sys.argv[4]) if len(sys.argv) > 4 else 60.0
    assert nclips % fold == 0
    ngroups = nclips // fold

    import jax
    import jax.numpy as jnp
    from flan_tpu.pipelines import pv_stretch_pipeline

    sr = 48000.0
    n = int(clip_seconds * sr)
    rng = np.random.default_rng(3)
    t = np.arange(n, dtype=np.float32) / sr
    base = np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)
    clips = (base[None] * rng.uniform(0.5, 1.0, (nclips, 1, 1))
             .astype(np.float32))
    groups = [jnp.asarray(clips[g * fold:(g + 1) * fold]
                          .reshape(fold * 2, n)) for g in range(ngroups)]
    for g in groups:
        g.block_until_ready()

    fj = jax.jit(lambda v: pv_stretch_pipeline(
        v, 2.0, window_size=2048, hop=128, dft_size=4096,
        sample_rate=48000.0, chunk_out=chunk_out))
    compiled = fj.lower(groups[0]).compile()

    def sync(outs):
        jax.block_until_ready(outs)

    sync([compiled(groups[0])])  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sync([compiled(g) for g in groups])
        best = min(best, time.perf_counter() - t0)

    total = clip_seconds * nclips
    print(json.dumps({
        "fold": fold, "chunk_out": chunk_out, "nclips": nclips,
        "wall_s": round(best, 3),
        "aggregate_x_realtime": round(total / best, 1)}))


if __name__ == "__main__":
    main()
