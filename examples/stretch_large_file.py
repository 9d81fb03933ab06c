"""Time-stretch a long file in O(chunk) memory - the headline pipeline.

pv_stretch_pipeline fuses STFT -> remap -> iSTFT per output chunk inside
one lax.scan, so the PV tensors (~2.5 GB per stereo minute at headline
settings) are never materialized. The same call is the headline
benchmark (bench.py).

Run: python examples/stretch_large_file.py in.wav out.wav [factor]
(with no arguments, synthesizes a demo input first)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    import numpy as np
    from flan_tpu import Audio
    from flan_tpu.pipelines import pv_stretch_pipeline

    if argv:
        in_path, out_path = argv[0], argv[1]
        factor = float(argv[2]) if len(argv) > 2 else 2.0
        audio = Audio.load_from_file(in_path)
    else:
        in_path, out_path, factor = "(synth demo)", "/tmp/stretched.wav", 2.0
        sr = 8000.0
        t = np.arange(int(4 * sr), dtype=np.float32) / sr
        sweep = 0.4 * np.sin(2 * np.pi * (220 + 110 * t) * t)
        audio = Audio.create_from_array(np.stack([sweep, sweep]), sr)

    # small windows for the CPU demo; at 48 kHz use the defaults
    # (window 2048, hop 128, dft 4096)
    small = audio.sample_rate <= 16000
    y = pv_stretch_pipeline(
        audio.data, factor, sample_rate=audio.sample_rate,
        **(dict(window_size=512, hop=64, dft_size=512) if small else {}))
    out = Audio.create_from_array(np.asarray(y), audio.sample_rate)
    out.save_to_file(out_path)
    print(f"{in_path}: {audio.num_frames} frames -> {out.num_frames} "
          f"({factor}x) -> {out_path}")
    return out


if __name__ == "__main__":
    main()
