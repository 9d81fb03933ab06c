"""AudioBuffer: the time-domain container.

JAX re-design of the reference AudioBuffer
(reference: src/flan/Audio/AudioBuffer.h:20-228). The reference stores a
channel-major std::vector<float>; here the buffer is a [channels, frames]
float32 JAX array resident in HBM, registered as a pytree so whole effect
chains can be jit-compiled/vmapped/pjit-sharded. All processing methods are
pure and return new objects (the reference's const-method convention).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class SndfileStrings:
    """Metadata block carried through WAV save/load.

    Mirrors the reference's 10-field metadata struct
    (reference: src/flan/Audio/AudioBuffer.h, AudioBuffer.cpp:102-111).
    """
    title: str = ""
    copyright: str = ""
    software: str = ""
    artist: str = ""
    comment: str = ""
    date: str = ""
    album: str = ""
    license: str = ""
    tracknumber: str = ""
    genre: str = ""


@dataclass(frozen=True)
class AudioFormat:
    """Static format info (reference AudioBuffer::Format)."""
    num_channels: int = 0
    num_frames: int = 0
    sample_rate: float = 48000.0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AudioBuffer:
    """[channels, frames] float32 device buffer + sample rate.

    `data` is a pytree leaf; `sample_rate` is static metadata, so jit caches
    key on it (sample-rate changes recompile, which matches how the rate
    threads through every algorithm as a compile-time constant).
    """
    data: jax.Array = field(
        default_factory=lambda: jnp.zeros((0, 0), jnp.float32))
    sample_rate: float = dataclasses.field(
        default=48000.0, metadata=dict(static=True))

    # --- Basic info (reference AudioBuffer.h getters) -----------------------
    @property
    def num_channels(self) -> int:
        return int(self.data.shape[0])

    @property
    def num_frames(self) -> int:
        return int(self.data.shape[1])

    @property
    def length(self) -> float:
        """Length in seconds."""
        return self.num_frames / self.sample_rate

    def get_format(self) -> AudioFormat:
        return AudioFormat(self.num_channels, self.num_frames,
                           float(self.sample_rate))

    def is_null(self) -> bool:
        return (self.num_channels == 0 or self.num_frames == 0
                or self.sample_rate <= 0)

    def is_nan_or_inf(self) -> bool:
        """Scan for non-finite samples (reference AudioBuffer.h:96)."""
        if self.is_null():
            return False
        return bool(jnp.any(~jnp.isfinite(self.data)))

    # --- Unit conversions ---------------------------------------------------
    def time_to_frame(self, t: float) -> int:
        return int(round(t * self.sample_rate))

    def frame_to_time(self, f: int) -> float:
        return f / self.sample_rate

    def print_summary(self) -> None:
        print(f"Audio: channels={self.num_channels} frames={self.num_frames} "
              f"sample_rate={self.sample_rate} length={self.length:.3f}s")

    # --- Sample access (host-side convenience; not for hot paths) -----------
    def get_sample(self, channel: int, frame: int) -> float:
        return float(self.data[channel, frame])

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)
