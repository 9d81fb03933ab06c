"""A/B the streamed-stretch step restructure leads.

The "super-chunk" grouping of G chunks per scan step is arithmetically
identical to chunk_out = G*chunk (the mod-1 cycle prefix is associative,
so local-cumsum + exclusive-prefix rotation IS one contiguous cumsum), so
the testable question is whether the per-step working set, not the step
count, sets the chunk-size optimum. These arms halve the remap-side working set
(bf16 mag + bf16 frequency-deviation planes, phase accumulation stays
f32) and/or swap the wblocks-slice framing restack for one static
gather, then re-sweep chunk_out.

Usage: python tools/ab_superchunk.py ARM [SECONDS] [CHUNK] [CHANNELS]
  ARM: control | bf16 | gather | bf16gather   (time on current backend)
       snr                                    (forced-CPU fidelity check)

Subprocess-isolate timing arms: the knobs are module globals read at
trace time and the jit cache does not key on them.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_input(seconds, channels, sr=48000.0):
    n = int(seconds * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    return np.stack([
        0.4 * np.sin(2 * np.pi * (220.0 + 10 * c) * t)
        + 0.1 * rng.standard_normal(n) for c in range(channels)
    ]).astype(np.float32)


def snr_main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import flan_tpu.pipelines.streamed as st
    from flan_tpu.pipelines import pv_stretch_pipeline

    x = jnp.asarray(make_input(4.0, 1))
    ref = np.asarray(pv_stretch_pipeline(x, 2.0))
    st._streamed_scan.clear_cache()
    st._REMAP_DTYPE = jnp.bfloat16
    out = np.asarray(pv_stretch_pipeline(x, 2.0))
    err = out - ref
    snr = 10.0 * np.log10(
        float(np.sum(ref * ref)) / max(float(np.sum(err * err)), 1e-30))
    print(json.dumps({"arm": "snr", "bf16_vs_f32_snr_db": round(snr, 1)}))


def main():
    arm = sys.argv[1]
    if arm == "snr":
        snr_main()
        return
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 150.0
    chunk_out = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    channels = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    import jax
    import jax.numpy as jnp
    import flan_tpu.pipelines.streamed as st
    if "bf16" in arm:
        st._REMAP_DTYPE = jnp.bfloat16
    if "gather" in arm:
        st._FRAMING_MODE = "gather"
    from flan_tpu.pipelines import pv_stretch_pipeline

    x = jnp.asarray(make_input(seconds, channels))
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
