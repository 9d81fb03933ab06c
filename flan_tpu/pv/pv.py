"""PV: phase-vocoder algorithm surface.

JAX re-design of the reference PV class
(reference: src/flan/PV/PV.h:27-490). PV is a stateless wrapper of PVBuffer;
every method is pure and returns a new PV. The compute path is batched JAX
ops over the [channels, frames, bins] mag/freq arrays (see flan_tpu.ops).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.core.pv_buffer import PVBuffer, PVFormat
from flan_tpu.func import interpolators
from flan_tpu.func.function import (Function, Function2d, as_function,
                                    as_function2d)
from flan_tpu.ops import pv_modify, stft


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PV(PVBuffer):
    """Phase-vocoder data with algorithms (reference PV/PV.h)."""

    # --- Constructors -------------------------------------------------------
    @staticmethod
    def create_null() -> "PV":
        return PV()

    @staticmethod
    def create_from_format(fmt: PVFormat) -> "PV":
        shape = (fmt.num_channels, fmt.num_frames, fmt.num_bins)
        return PV(mag=jnp.zeros(shape, jnp.float32),
                  freq=jnp.zeros(shape, jnp.float32),
                  sample_rate=fmt.sample_rate, hop_size=fmt.hop_size,
                  window_size=fmt.window_size)

    @staticmethod
    def load_from_file(filename: str) -> "PV":
        """Load a RIFF .flan file (reference PVBuffer.cpp:216)."""
        from flan_tpu.io.flan_format import read_flan
        mag, freq, sr, hop, window = read_flan(filename)
        return PV(mag=jnp.asarray(mag), freq=jnp.asarray(freq),
                  sample_rate=sr, hop_size=hop, window_size=window)

    def save(self, filename: str) -> None:
        """Save as RIFF .flan (reference PVBuffer.cpp:99)."""
        from flan_tpu.io.flan_format import write_flan
        write_flan(filename, np.asarray(self.mag), np.asarray(self.freq),
                   self.sample_rate, self.hop_size, self.window_size)

    def copy(self) -> "PV":
        return self._with(mag=self.mag, freq=self.freq)

    # --- Function sampling conveniences (reference PV.h:31-48) ---------------
    def sample_function_over_domain(self, f):
        """Rasterize a Function over the frame x bin grid: time step
        1/analysis_rate, frequency step bin_width
        (reference PV.h:32-35). Constants stay O(1)."""
        from flan_tpu.func.function_sample import FunctionSample2d
        fn = as_function2d(f)
        vals = fn.sample_grid(self.num_frames, 1.0 / self.analysis_rate,
                              self.num_bins, self.bin_width)
        return FunctionSample2d(vals, self.num_frames, self.num_bins)

    def sample_function_over_time_domain(self, f):
        """Rasterize a Function over frame times (reference PV.h:38-48)."""
        from flan_tpu.func.function_sample import FunctionSample
        fn = as_function(f)
        vals = fn.sample(0, self.num_frames, 1.0 / self.analysis_rate)
        return FunctionSample(vals, self.num_frames)

    def _with(self, **kwargs) -> "PV":
        return dataclasses.replace(self, **kwargs)

    # --- Conversions --------------------------------------------------------
    def convert_to_audio(self):
        """Inverse phase vocoder + overlap-add (reference
        Conversions/AudioPV.cpp:86-139, incl. the 2.67 gain convention)."""
        from flan_tpu.audio.audio import Audio
        if self.is_null():
            return Audio.create_null()
        data = stft.pv_inverse(self.mag, self.freq,
                               window_size=self.window_size,
                               hop=self.hop_size,
                               sample_rate=float(self.sample_rate))
        return Audio(data=data, sample_rate=self.sample_rate)

    def convert_to_lr_audio(self):
        """Inverse of Audio.convert_to_ms_PV (AudioPV.cpp:141-145)."""
        from flan_tpu.audio.audio import Audio
        if self.num_channels != 2:
            return Audio.create_null()
        return self.convert_to_audio().convert_to_left_right()

    # --- Utility ------------------------------------------------------------
    def get_frame(self, time: float) -> "PV":
        """Linear interpolation of the frames surrounding `time`
        (reference PV.cpp get_frame)."""
        if self.is_null():
            return PV.create_null()
        x = float(self.time_to_frame(time))
        lo = int(np.clip(np.floor(x), 0, self.num_frames - 1))
        hi = int(np.clip(lo + 1, 0, self.num_frames - 1))
        r = jnp.float32(x - lo)
        mag = (1 - r) * self.mag[:, lo:lo + 1] + r * self.mag[:, hi:hi + 1]
        freq = (1 - r) * self.freq[:, lo:lo + 1] + r * self.freq[:, hi:hi + 1]
        return self._with(mag=mag, freq=freq)

    def cut_frames(self, start: int, end: int) -> "PV":
        """Keep frames [start, end) (reference PV.cpp:643-668).

        Reference quirk (golden-tested via algo_pvjoin): BOTH bounds are
        clamped to num_frames - 1, so the LAST frame can never be
        included — cut_frames(a, num_frames) yields num_frames - 1 - a
        frames. The end<=start null check runs before the clamp."""
        start, end = int(start), int(end)
        if end <= start:
            return PV.create_null()
        start = int(np.clip(start, 0, self.num_frames - 1))
        end = int(np.clip(end, 0, self.num_frames - 1))
        return self._with(mag=self.mag[:, start:end],
                          freq=self.freq[:, start:end])

    def split_at_times(self, split_times: Sequence[float]) -> List["PV"]:
        """Split at frame boundaries (reference PV.cpp:670-697).

        Quirks preserved: split frames TRUNCATE (the Frame cast of
        time_to_frame), duplicate split times yield null pieces (the
        reference never dedupes split_frames), and the final piece
        loses one frame to cut_frames' end clamp."""
        frames = sorted(int(self.time_to_frame(t)) for t in split_times)
        bounds = [0] + [f for f in frames if 0 < f < self.num_frames] \
            + [self.num_frames]
        return [self.cut_frames(a, b) for a, b in zip(bounds, bounds[1:])]

    @staticmethod
    def join(ins: Sequence["PV"]) -> "PV":
        """Concatenate along frames (reference PV.cpp:698)."""
        ins = [p for p in ins if not p.is_null()]
        if not ins:
            return PV.create_null()
        first = ins[0]
        mag = jnp.concatenate([p.mag for p in ins], axis=1)
        freq = jnp.concatenate([p.freq for p in ins], axis=1)
        return first._with(mag=mag, freq=freq)

    # --- Resampling (reference PVModify.cpp) --------------------------------
    def _sample_2d(self, f) -> jnp.ndarray:
        """Sample a Function2d over the (frame, bin) grid -> [F, B] or [F, 1]
        for bin-independent input."""
        fn = as_function2d(f)
        if fn.is_constant:
            return jnp.full((self.num_frames, 1), fn.constant_value,
                            jnp.float32)
        out = fn.sample_grid(self.num_frames, 1.0 / self.analysis_rate,
                             self.num_bins, self.bin_width)
        return out

    def stretch(self, factor, interp: Callable = interpolators.linear,
                ) -> "PV":
        """Time stretch: partial time-integral of factor -> monotonic remap
        (reference PVModify.cpp:371-385). factor must be positive."""
        if self.is_null():
            return PV.create_null()
        sampled = self._sample_2d(factor)           # [F, Bm] frames per frame
        time_map = jnp.cumsum(sampled, axis=0)      # inclusive, in PV frames
        out_frames = int(np.ceil(float(jnp.max(time_map))))
        out_mag, out_freq = pv_modify.modify_time_gather(
            self.mag, self.freq, time_map, out_frames=out_frames,
            interp=interp)
        return self._with(mag=out_mag, freq=out_freq)

    def modify_time(self, mod, interp: Callable = interpolators.linear,
                    ) -> "PV":
        """Arbitrary monotonic time remap (reference PVModify.cpp:364-369).
        mod maps (t, f) -> output seconds; must be increasing in t."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(mod)
        # Reference grid: t = frame * (1.0f/analysis_rate) in f32
        # (Function.h:165-167 x*x_scale) - NOT frame/analysis_rate. The
        # 1-ulp difference flips the output-size ceil (golden-tested:
        # 0.001f > 1/1000 exactly makes ceil(46.000002) = 47 frames).
        t = jnp.arange(self.num_frames, dtype=jnp.float32) \
            * jnp.float32(1.0 / self.analysis_rate)
        if fn.is_constant:
            raise ValueError("modify_time requires a time-dependent mod")
        fr = jnp.arange(self.num_bins, dtype=jnp.float32) * self.bin_width
        mapped = fn(t[:, None], fr[None, :])        # [F, B] seconds
        mapped = jnp.broadcast_to(mapped, (self.num_frames, self.num_bins))
        time_map = mapped * self.analysis_rate      # to PV frames
        out_frames = int(np.ceil(float(jnp.max(time_map))))
        out_mag, out_freq = pv_modify.modify_time_gather(
            self.mag, self.freq, time_map, out_frames=out_frames,
            interp=interp)
        return self._with(mag=out_mag, freq=out_freq)

    def repitch(self, factor, interp: Callable = interpolators.linear,
                ) -> "PV":
        """Pitch scale: partial bin-integral of factor -> monotonic frequency
        remap (reference PVModify.cpp:273-305). factor must be positive."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(factor)
        if fn.is_constant and interp is interpolators.linear:
            # host-precomputed inverse bin map: static gathers instead of
            # the searchsorted + data-dependent-gather path (see
            # modify_frequency_gather_const)
            out_mag, out_freq = pv_modify.modify_frequency_gather_const(
                self.mag, self.freq, float(fn.constant_value),
                self.bin_width)
            return self._with(mag=out_mag, freq=out_freq)
        t = jnp.arange(self.num_frames, dtype=jnp.float32) \
            * jnp.float32(1.0 / self.analysis_rate)
        b = jnp.arange(self.num_bins, dtype=jnp.float32) * self.bin_width
        sampled = jnp.broadcast_to(fn(t[:, None], b[None, :]),
                                   (self.num_frames, self.num_bins))
        # partial integral over bins, keeping bin 0 as its own factor
        bin_map = jnp.cumsum(sampled, axis=1)       # [F, B] in bins
        freq_map_hz = bin_map * self.bin_width

        # map each MF's own frequency through the integrated curve
        # (reference PVModify.cpp:287-302): linear interp of freq_map at the
        # MF's fractional bin position.
        fbin = jnp.clip(self.freq / self.bin_width, 0.0,
                        self.num_bins - 1 - 1e-4)
        lo = jnp.floor(fbin).astype(jnp.int32)
        r = fbin - lo
        lo_val = jnp.take_along_axis(
            freq_map_hz[None], lo.reshape(self.num_channels,
                                          self.num_frames, -1), axis=2)
        hi_val = jnp.take_along_axis(
            freq_map_hz[None], (lo + 1).reshape(self.num_channels,
                                                self.num_frames, -1), axis=2)
        freq_modified = lo_val * (1 - r) + hi_val * r

        out_mag, out_freq = pv_modify.modify_frequency_gather(
            self.mag, freq_modified, bin_map, interp=interp)
        return self._with(mag=out_mag, freq=out_freq)

    def modify_frequency(self, mod, interp: Callable = interpolators.linear,
                         ) -> "PV":
        """Arbitrary monotonic frequency remap
        (reference PVModify.cpp:259-271)."""
        if self.is_null():
            return PV.create_null()
        fn = as_function2d(mod)
        t = jnp.arange(self.num_frames, dtype=jnp.float32) \
            * jnp.float32(1.0 / self.analysis_rate)
        b = jnp.arange(self.num_bins, dtype=jnp.float32) * self.bin_width
        mapped_hz = jnp.broadcast_to(fn(t[:, None], b[None, :]),
                                     (self.num_frames, self.num_bins))
        bin_map = mapped_hz / self.bin_width
        t3 = t[None, :, None]
        freq_modified = fn(jnp.broadcast_to(
            t3, self.freq.shape), self.freq)
        freq_modified = jnp.broadcast_to(freq_modified, self.freq.shape)
        out_mag, out_freq = pv_modify.modify_frequency_gather(
            self.mag, freq_modified, bin_map, interp=interp)
        return self._with(mag=out_mag, freq=out_freq)
