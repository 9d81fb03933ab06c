"""PVBuffer: phase-vocoder (time x frequency) container.

JAX re-design of the reference PVBuffer
(reference: src/flan/PV/PVBuffer.h:27-288). The reference stores interleaved
MF{mag, freq} structs in channel->frame->bin order (AoS). On the device the
natural layout is SoA: two [channels, frames, bins] float32 arrays, which
vectorizes over bins and lets magnitude-only ops touch half the bytes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class PVFormat:
    """Static format info (reference PVBuffer::Format, PVBuffer.h:43-52)."""
    num_channels: int = 0
    num_frames: int = 0
    num_bins: int = 0
    sample_rate: float = 48000.0
    hop_size: int = 128
    window_size: int = 2048

    @property
    def analysis_rate(self) -> float:
        return self.sample_rate / self.hop_size

    @property
    def dft_size(self) -> int:
        return 2 * (self.num_bins - 1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PVBuffer:
    """SoA phase-vocoder buffer.

    mag, freq: [channels, frames, bins] float32 device arrays (pytree leaves).
    sample_rate / hop_size / window_size: static metadata. analysis_rate and
    dft_size are derived (reference stores analysis_rate; we store the integer
    hop which is exact).
    """
    mag: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    freq: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0, 0), jnp.float32))
    sample_rate: float = dataclasses.field(
        default=48000.0, metadata=dict(static=True))
    hop_size: int = dataclasses.field(default=128, metadata=dict(static=True))
    window_size: int = dataclasses.field(
        default=2048, metadata=dict(static=True))

    # --- Info ---------------------------------------------------------------
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
        """PV frames per second (reference PVBuffer.h:49)."""
        return self.sample_rate / self.hop_size

    @property
    def dft_size(self) -> int:
        return 2 * (self.num_bins - 1)

    @property
    def length(self) -> float:
        """Length in seconds."""
        return self.num_frames / self.analysis_rate

    def get_format(self) -> PVFormat:
        return PVFormat(self.num_channels, self.num_frames, self.num_bins,
                        float(self.sample_rate), self.hop_size,
                        self.window_size)

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.num_bins == 0 or self.sample_rate <= 0)

    def is_nan_or_inf(self) -> bool:
        if self.is_null():
            return False
        return bool(jnp.any(~jnp.isfinite(self.mag))
                    | jnp.any(~jnp.isfinite(self.freq)))

    # --- Unit conversions (reference PVBuffer.h:201-231) --------------------
    def frame_to_time(self, f) -> float:
        return f / self.analysis_rate

    def time_to_frame(self, t) -> float:
        return t * self.analysis_rate

    def bin_to_frequency(self, b) -> float:
        return b * self.bin_width

    def frequency_to_bin(self, f) -> float:
        return f / self.bin_width

    @property
    def bin_width(self) -> float:
        """Hz per bin = sample_rate / dft_size."""
        return self.sample_rate / self.dft_size

    @property
    def max_frequency(self) -> float:
        return self.bin_to_frequency(self.num_bins - 1)

    def print_summary(self) -> None:
        print(f"PV: channels={self.num_channels} frames={self.num_frames} "
              f"bins={self.num_bins} sample_rate={self.sample_rate} "
              f"hop={self.hop_size} window={self.window_size}")

    def get_max_partial_magnitude(self, start_frame: int = 0,
                                  end_frame: int = 0, start_bin: int = 0,
                                  end_bin: int = 0) -> float:
        """Max |magnitude| over a window (reference PVBuffer.h:164-171;
        zero end means 'to the end')."""
        if self.is_null():
            return 0.0
        ef = end_frame if end_frame != 0 else self.num_frames
        eb = end_bin if end_bin != 0 else self.num_bins
        return float(jnp.max(jnp.abs(
            self.mag[:, start_frame:ef, start_bin:eb])))

    def get_MF(self, channel: int, frame: int, b: int):
        return (float(self.mag[channel, frame, b]),
                float(self.freq[channel, frame, b]))

    def to_numpy(self):
        return np.asarray(self.mag), np.asarray(self.freq)
