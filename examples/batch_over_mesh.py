"""Process a batch of clips data-parallel over the device mesh.

parallel.batch.map_sharded shards equal-shaped clips across
jax.devices() with one pjit program; on several GPUs each device
stretches its share. Runs on any device count, including a virtual CPU
mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8).

Run: python examples/batch_over_mesh.py [n_clips]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    n_clips = int(argv[0]) if argv else 8

    import numpy as np
    import jax

    from flan_tpu.parallel import batch as pbatch
    from flan_tpu.pipelines import pv_stretch_pipeline

    sr = 8000.0
    n = int(2 * sr)
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / sr
    clips = [
        (0.4 * np.sin(2 * np.pi * (200.0 + 50 * k) * t)[None]
         + 0.02 * rng.standard_normal((1, n))).astype(np.float32)
        for k in range(n_clips)
    ]  # n_clips x [1, n]

    print(f"{n_clips} clips over {len(jax.devices())} device(s)")
    outs = pbatch.map_sharded(
        lambda x: pv_stretch_pipeline(x, 2.0, window_size=512, hop=64,
                                      dft_size=512, sample_rate=sr),
        clips)
    outs = np.stack([np.asarray(o) for o in outs])
    print("in", (len(clips),) + clips[0].shape, "->", outs.shape)
    return outs


if __name__ == "__main__":
    main()
