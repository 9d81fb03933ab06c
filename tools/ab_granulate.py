"""A/B the granulate grain extraction: block-row gather vs per-element.

Usage: python tools/ab_granulate.py \
    planned|slicemap|elem|block|mix_none|mix_sorted
Runs the bench_convolve_texture granulate config (30 s stereo, 20
grains/s, 0.1 s grains). Subprocess-isolate per arm (one process per
card).
"planned" is the round-4 default (fused-alignment gather + host-planned
K-pass gather mixer); every other arm forces the legacy align+scatter
render with the named variant.
"""
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    arm = sys.argv[1]
    import jax
    import jax.numpy as jnp
    from flan_tpu import Audio
    from flan_tpu.audio import synthesis

    orig = synthesis._granulate_render
    if arm == "planned":
        assert synthesis._RENDER_MODE == "planned"
    elif arm.startswith("mix_"):
        synthesis._RENDER_MODE = "legacy"
        synthesis._granulate_render = functools.partial(
            orig, mix_mode=arm[4:])
    else:
        synthesis._RENDER_MODE = "legacy"
        synthesis._granulate_render = functools.partial(
            orig, gather_mode=arm)

    seconds = 30.0
    sr = 48000.0
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n),
        0.4 * np.sin(2 * np.pi * 330.0 * t) + 0.1 * rng.standard_normal(n),
    ]).astype(np.float32)
    a = Audio(data=jnp.asarray(x), sample_rate=sr)

    def sync(y):
        jax.block_until_ready(y)

    def run():
        out = a.granulate(seconds, 20.0, 0.1, lambda tt: 0.5 * tt, 0.1,
                          0.01, seed=0)
        sync(out.data)

    run()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({"arm": arm, "ms": round(best * 1e3, 1),
                      "x_realtime": round(seconds / best, 1)}))


if __name__ == "__main__":
    main()
