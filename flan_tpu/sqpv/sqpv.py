"""SQPV: sliding constant-Q phase-vocoder buffer and algorithms.

JAX port of the reference SQPVBuffer
(reference: src/flan/SQPV/SQPVBuffer.h:14-79, SQPVBuffer.cpp:17-31,
Utility/MP.h:9-33). The algorithm layer above the buffer is written but
entirely commented out upstream (SQPV/SQPV.cpp:1,
Conversions/AudioSQPV.cpp:1); here it is ACTIVATED: the sliding
constant-Q transform lives in flan_tpu/sqpv/transform.py and the
buffer-level algorithms (convert_to_audio, modify_pitch, repitch, select,
convert_to_graph) below follow the intent of that dormant code.

Data is SoA: magnitude and *pitch* (log2 |frequency|) planes plus a sign
plane tracking negative frequencies (the reference packs a bool into its MP
struct for the same reason).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SQPV:
    """Constant-Q spectral data: mag / pitch / sign [C, F, B]."""
    mag: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    pitch: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    positive: jax.Array = field(
        default_factory=lambda: jnp.ones((0, 0, 0), jnp.bool_))
    sample_rate: float = dataclasses.field(
        default=48000.0, metadata=dict(static=True))
    bins_per_octave: float = dataclasses.field(
        default=24.0, metadata=dict(static=True))
    bandwidth: Tuple[float, float] = dataclasses.field(
        default=(16.0, 24000.0), metadata=dict(static=True))

    # --- Info ----------------------------------------------------------------
    @property
    def num_channels(self) -> int:
        return int(self.mag.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.mag.shape[1])

    @property
    def num_bins(self) -> int:
        return int(self.mag.shape[2])

    @property
    def analysis_rate(self) -> float:
        return self.sample_rate

    @property
    def q(self) -> float:
        """Cycles per analysis: 1 / (2^(1/bpo) - 1)
        (reference SQPVBuffer.cpp:22)."""
        return 1.0 / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    # --- Unit conversions (reference SQPVBuffer.cpp) -------------------------
    def frequency_to_pitch(self, f) -> float:
        return math.log2(max(abs(f), 1e-12))

    def pitch_to_frequency(self, p) -> float:
        return 2.0 ** p

    @property
    def pitch_bandwidth(self) -> Tuple[float, float]:
        return (self.frequency_to_pitch(self.bandwidth[0]),
                self.frequency_to_pitch(self.bandwidth[1]))

    def pitch_to_bin(self, p) -> float:
        return (p - self.pitch_bandwidth[0]) * self.bins_per_octave

    def bin_to_pitch(self, b) -> float:
        return b / self.bins_per_octave + self.pitch_bandwidth[0]

    def frequency_to_bin(self, f) -> float:
        return self.pitch_to_bin(self.frequency_to_pitch(f))

    def bin_to_frequency(self, b) -> float:
        return self.pitch_to_frequency(self.bin_to_pitch(b))

    def bin_frequencies(self) -> np.ndarray:
        return np.asarray([self.bin_to_frequency(b)
                           for b in range(self.num_bins)])

    def get_period(self, b: int) -> int:
        """Frames per analysis at bin b: Q cycles at the bin frequency
        (reference SQPVBuffer getPeriod)."""
        return int(math.ceil(self.q / self.bin_to_frequency(b)
                             * self.sample_rate))

    def time_to_frame(self, t) -> float:
        return t * self.sample_rate

    def frame_to_time(self, f) -> float:
        return f / self.sample_rate

    @staticmethod
    def num_bins_for(bandwidth: Tuple[float, float],
                     bins_per_octave: float) -> int:
        """ceil(frequency_to_bin(top)) (reference SQPVBuffer.cpp:21)."""
        lo = math.log2(bandwidth[0])
        hi = math.log2(bandwidth[1])
        return int(math.ceil((hi - lo) * bins_per_octave))

    @staticmethod
    def create(num_channels: int, num_frames: int,
               bins_per_octave: float = 24.0,
               sample_rate: float = 48000.0,
               bandwidth: Tuple[float, float] = (16.0, 24000.0)) -> "SQPV":
        b = SQPV.num_bins_for(bandwidth, bins_per_octave)
        shape = (num_channels, num_frames, b)
        return SQPV(mag=jnp.zeros(shape, jnp.float32),
                    pitch=jnp.zeros(shape, jnp.float32),
                    positive=jnp.ones(shape, jnp.bool_),
                    sample_rate=sample_rate,
                    bins_per_octave=bins_per_octave, bandwidth=bandwidth)

    @staticmethod
    def create_null() -> "SQPV":
        return SQPV()

    def _with(self, **kwargs) -> "SQPV":
        return dataclasses.replace(self, **kwargs)

    def copy(self) -> "SQPV":
        return self._with()

    def get_max_partial_magnitude(self) -> float:
        return float(jnp.max(jnp.abs(self.mag))) if not self.is_null() \
            else 0.0

    # --- Algorithms (activating the dormant reference SQPV/SQPV.cpp) ---------
    def modify_pitch(self, mod) -> "SQPV":
        """Replace each MP's pitch with mod(time, pitch)
        (reference SQPV.cpp:71-89, dormant upstream)."""
        if self.is_null():
            return SQPV.create_null()
        from flan_tpu.func.function import as_function2d
        fn = as_function2d(mod)
        t = jnp.arange(self.num_frames,
                       dtype=jnp.float32)[None, :, None] / self.sample_rate
        tt = jnp.broadcast_to(t, self.pitch.shape)
        new_pitch = jnp.broadcast_to(
            jnp.asarray(fn(tt, self.pitch), jnp.float32), self.pitch.shape)
        return self._with(pitch=new_pitch)

    def repitch(self, factor) -> "SQPV":
        """Scale each MP's frequency by factor(time, pitch)
        (reference SQPV.h:24, dormant upstream). Pitch is log2 |frequency|,
        so a frequency factor is a pitch offset of log2(factor); this
        mirrors the live SPV::repitch (SPV.cpp:41-44), which multiplies
        frequency by the sampled factor."""
        from flan_tpu.func.function import as_function2d
        fn = as_function2d(factor)
        return self.modify_pitch(
            lambda t, p: p + jnp.log2(jnp.maximum(
                jnp.abs(jnp.asarray(fn(t, p), jnp.float32)), 1e-12)))

    def select(self, length: float, selector) -> "SQPV":
        """Gather frames through selector(time, pitch) -> selected time,
        time-interpolating magnitudes and keeping the dominant side's pitch
        (reference SQPV.cpp:91-142, dormant upstream; as there, the
        selected pitch chooses the source *time* only — data stays in its
        bin — and out-of-range selections produce zeros)."""
        if self.is_null() or length <= 0:
            return SQPV.create_null()
        from flan_tpu.func.function import as_function2d
        fn = as_function2d(selector)
        out_frames = int(length * self.sample_rate)
        t = jnp.arange(out_frames,
                       dtype=jnp.float32)[None, :, None] / self.sample_rate
        pitches = jnp.asarray(
            [self.bin_to_pitch(b) for b in range(self.num_bins)],
            jnp.float32)[None, None, :]
        sel_t = jnp.asarray(fn(jnp.broadcast_to(t, (1, out_frames,
                                                    self.num_bins)),
                               jnp.broadcast_to(pitches,
                                                (1, out_frames,
                                                 self.num_bins))),
                            jnp.float32)
        sel_frame = jnp.broadcast_to(sel_t * self.sample_rate,
                                     (1, out_frames, self.num_bins))[0]
        lo = jnp.floor(sel_frame)
        mix = sel_frame - lo
        valid = (sel_frame >= 0) & (sel_frame < self.num_frames - 1)
        lo_i = jnp.clip(lo.astype(jnp.int32), 0, self.num_frames - 1)
        hi_i = jnp.clip(lo_i + 1, 0, self.num_frames - 1)

        def gather(plane, idx):
            return jnp.take_along_axis(plane, idx[None], axis=1)

        bcast_lo = jnp.broadcast_to(lo_i, (out_frames, self.num_bins))
        bcast_hi = jnp.broadcast_to(hi_i, (out_frames, self.num_bins))
        m_l = jnp.concatenate([gather(self.mag[c:c + 1], bcast_lo)
                               for c in range(self.num_channels)], axis=0)
        m_r = jnp.concatenate([gather(self.mag[c:c + 1], bcast_hi)
                               for c in range(self.num_channels)], axis=0)
        p_l = jnp.concatenate([gather(self.pitch[c:c + 1], bcast_lo)
                               for c in range(self.num_channels)], axis=0)
        p_r = jnp.concatenate([gather(self.pitch[c:c + 1], bcast_hi)
                               for c in range(self.num_channels)], axis=0)
        s_l = jnp.concatenate([gather(self.positive[c:c + 1], bcast_lo)
                               for c in range(self.num_channels)], axis=0)
        s_r = jnp.concatenate([gather(self.positive[c:c + 1], bcast_hi)
                               for c in range(self.num_channels)], axis=0)
        w1 = (1.0 - mix)[None] * m_l
        w2 = mix[None] * m_r
        vmask = valid[None].astype(jnp.float32)
        mag = (w1 + w2) * vmask
        left_wins = w1 > w2
        pitch = jnp.where(left_wins, p_l, p_r) * vmask
        positive = jnp.where(left_wins, s_l, s_r) | ~valid[None]
        return self._with(mag=mag, pitch=pitch, positive=positive)

    # --- Conversions (activating the dormant AudioSQPV.cpp inverse) ----------
    def convert_to_audio(self):
        from flan_tpu.audio.audio import Audio
        from flan_tpu.sqpv.transform import sqpv_inverse
        if self.is_null():
            return Audio.create_null()
        data = sqpv_inverse(self.mag, self.pitch, self.positive,
                            self.sample_rate, self.bins_per_octave,
                            self.bandwidth)
        return Audio(data=data, sample_rate=float(self.sample_rate))

    def convert_to_lr_audio(self):
        """(reference AudioSQPV.cpp:167-170, dormant upstream)."""
        return self.convert_to_audio().convert_to_left_right()

    def convert_to_graph(self, width: int = -1, height: int = -1):
        """Pitch-axis magnitude spectrogram, sqrt scaling to bring up dark
        areas (reference SQPV.cpp:21-68, dormant upstream)."""
        from flan_tpu.graph.graph import Graph
        from flan_tpu.utils.geometry import Rect
        g = Graph(width, height)
        if self.is_null():
            return g
        lo_p, hi_p = self.pitch_bandwidth
        domain = Rect(0.0, lo_p, self.num_frames / self.sample_rate, hi_p)
        max_mag = self.get_max_partial_magnitude()
        g.add_full_split_view_y(domain, self.num_channels)
        if max_mag > 0:
            vals = jnp.sqrt(jnp.abs(self.mag) / max_mag)
            vals_np = np.asarray(jnp.clip(vals, 0.0, 1.0))
            g.draw_spectrograms(
                [vals_np[c] for c in range(self.num_channels)], domain)
        return g

    def save_to_bmp(self, filename: str, width: int = -1,
                    height: int = -1) -> None:
        self.convert_to_graph(width, height).save_image(filename)
