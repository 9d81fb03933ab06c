"""Audio: time-domain algorithm surface.

JAX re-design of the reference Audio class
(reference: src/flan/Audio/Audio.h:25-1150). Audio is a stateless wrapper of
AudioBuffer; every method is pure and returns a new Audio (the reference's
const-method convention). Algorithms are batched JAX ops over the
[channels, frames] array; per-method kernels live in flan_tpu.ops and
sibling modules in flan_tpu.audio.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.core.audio_buffer import (AudioBuffer, AudioFormat,
                                        SndfileStrings)
from flan_tpu.func import interpolators
from flan_tpu.func.function import Function, as_function
from flan_tpu.ops import stft

_SQRT2 = math.sqrt(2.0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Audio(AudioBuffer):
    """Audio data with algorithms (reference Audio/Audio.h)."""

    def _with(self, **kwargs) -> "Audio":
        return dataclasses.replace(self, **kwargs)

    # =======================================================================
    # Constructors (reference Audio.h:44-97, AudioConstructors.cpp)
    # =======================================================================
    @staticmethod
    def create_null() -> "Audio":
        return Audio()

    @staticmethod
    def create_from_buffer(buffer, num_channels: int,
                           sample_rate: float) -> "Audio":
        data = jnp.asarray(buffer, jnp.float32).reshape(num_channels, -1)
        return Audio(data=data, sample_rate=float(sample_rate))

    @staticmethod
    def create_from_array(array, sample_rate: float = 48000.0) -> "Audio":
        data = jnp.atleast_2d(jnp.asarray(array, jnp.float32))
        return Audio(data=data, sample_rate=float(sample_rate))

    @staticmethod
    def create_from_format(fmt: AudioFormat) -> "Audio":
        return Audio(data=jnp.zeros((fmt.num_channels, fmt.num_frames),
                                    jnp.float32),
                     sample_rate=float(fmt.sample_rate))

    @staticmethod
    def create_empty_with_length(length: float, num_channels: int = 1,
                                 sample_rate: float = 48000.0) -> "Audio":
        frames = int(math.ceil(length * sample_rate))
        return Audio.create_empty_with_frames(frames, num_channels,
                                              sample_rate)

    @staticmethod
    def create_empty_with_frames(num_frames: int, num_channels: int = 1,
                                 sample_rate: float = 48000.0) -> "Audio":
        return Audio(data=jnp.zeros((num_channels, num_frames), jnp.float32),
                     sample_rate=float(sample_rate))

    @staticmethod
    def load_from_file(filename: str,
                       return_strings: bool = False):
        """Load WAV, FLAC, AIFF/AIFF-C, Ogg/Vorbis, AU, CAF, or Wave64,
        sniffed by stream magic
        (reference AudioConstructors.cpp:35; libsndfile format dispatch
        AudioBuffer.cpp:86-117)."""
        with open(filename, "rb") as f:
            head = f.read(12)
        magic = head[:4]
        if magic == b"fLaC":
            from flan_tpu.io.flac import read_flac
            data, sr = read_flac(filename)
            strings = SndfileStrings()
        elif magic == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
            from flan_tpu.io.aiff import read_aiff
            data, sr = read_aiff(filename)
            strings = SndfileStrings()
        elif magic == b"OggS":
            from flan_tpu.io.ogg import read_ogg
            data, sr = read_ogg(filename)
            strings = SndfileStrings()
        elif magic == b".snd":
            from flan_tpu.io.au import read_au
            data, sr = read_au(filename)
            strings = SndfileStrings()
        elif magic == b"caff":
            from flan_tpu.io.caf import read_caf
            data, sr = read_caf(filename)
            strings = SndfileStrings()
        elif magic == b"riff":           # Wave64's lowercase riff GUID
            from flan_tpu.io.w64 import read_w64
            data, sr = read_w64(filename)
            strings = SndfileStrings()
        elif magic[:3] == b"ID3" or (
                len(head) >= 2 and head[0] == 0xFF
                and (head[1] & 0xE0) == 0xE0
                and (head[1] >> 1) & 0x3 != 0):  # MPEG frame sync
            from flan_tpu.io.mp3 import read_mp3
            data, sr = read_mp3(filename)
            strings = SndfileStrings()
        else:
            from flan_tpu.io.wav import read_wav
            data, sr, strings = read_wav(filename)
        audio = Audio(data=jnp.asarray(data), sample_rate=sr)
        return (audio, strings) if return_strings else audio

    def save_to_file(self, filename: str,
                     strings: Optional[SndfileStrings] = None) -> None:
        """Save WAV float32, FLAC for .flac, AIFF-C float32 for
        .aiff/.aif/.aifc, Ogg/Vorbis for .ogg/.oga, AU for .au/.snd,
        CAF for .caf, or Wave64 for .w64 (reference
        AudioBuffer.cpp:139-190)."""
        low = filename.lower()
        if low.endswith((".au", ".snd")):
            from flan_tpu.io.au import write_au
            write_au(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith(".caf"):
            from flan_tpu.io.caf import write_caf
            write_caf(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith(".w64"):
            from flan_tpu.io.w64 import write_w64
            write_w64(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith(".mp3"):
            from flan_tpu.io.mp3 import write_mp3
            write_mp3(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith(".flac"):
            from flan_tpu.io.flac import write_flac
            write_flac(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith((".aiff", ".aif", ".aifc")):
            from flan_tpu.io.aiff import write_aiff
            write_aiff(filename, np.asarray(self.data), self.sample_rate)
            return
        if low.endswith((".ogg", ".oga")):
            from flan_tpu.io.ogg import write_ogg
            write_ogg(filename, np.asarray(self.data), self.sample_rate)
            return
        from flan_tpu.io.wav import write_wav
        write_wav(filename, np.asarray(self.data), self.sample_rate, strings)

    def copy(self) -> "Audio":
        return self._with(data=self.data)

    @staticmethod
    def match_sample_rates_or_return_null(ins):
        """If all inputs share a sample rate, return []; else return every
        input resampled to the highest rate
        (reference AudioCombination.cpp:17-35)."""
        ins = list(ins)
        if not ins:
            return []
        max_sr = max(a.sample_rate for a in ins)
        if all(a.sample_rate == max_sr for a in ins):
            return []
        return [a.resample(max_sr) for a in ins]

    def sample_function_over_domain(self, f):
        """Rasterize a Function over sample times, period 1/sample_rate
        (reference Audio.h:34-38). Constants stay O(1)."""
        from flan_tpu.func.function_sample import FunctionSample
        fn = as_function(f)
        vals = fn.sample(0, self.num_frames, 1.0 / self.sample_rate)
        return FunctionSample(vals, self.num_frames)

    # =======================================================================
    # Conversions (reference Audio.h:101-234)
    # =======================================================================
    def resample(self, new_sample_rate: float) -> "Audio":
        """Whole-buffer SRC, r8brain equivalent (reference
        AudioConversions.cpp:14-30) via polyphase windowed-sinc conv
        (flan_tpu.ops.resample).

        Reference quirk preserved (golden-tested): the reference feeds
        the ENTIRE channel-major flat buffer through ONE stateful
        resampler (``resampler.oneshot(&buffer[0], buffer.size(), ...)``),
        so channels bleed at the boundary and channel c lands at stream
        offset c*N*ratio — fractional in general, shifting later channels
        by a sub-sample amount. We reproduce this by resampling the flat
        [C*N] stream and reshaping to [C, floor(N*ratio)]; the clean
        per-channel form remains available as ops.resample.resample."""
        from flan_tpu.ops.resample import resample as _resample
        if self.is_null():
            return Audio.create_null()
        if new_sample_rate == self.sample_rate:
            return self.copy()
        c = self.num_channels
        if c == 1:
            data = _resample(self.data, float(self.sample_rate),
                             float(new_sample_rate))
        else:
            ratio = float(new_sample_rate) / float(self.sample_rate)
            out_n = int(self.num_frames * ratio)
            flat = _resample(self.data.reshape(1, -1),
                             float(self.sample_rate),
                             float(new_sample_rate))
            flat = flat[0, :c * out_n]
            data = flat.reshape(c, out_n)
        return Audio(data=data, sample_rate=float(new_sample_rate))

    def convert_to_PV(self, window_size: int = 2048, hop: int = 128,
                      dft_size: int = 4096):
        """STFT + phase vocode (reference Conversions/AudioPV.cpp:12-78)."""
        from flan_tpu.pv.pv import PV
        if self.is_null():
            return PV.create_null()
        mag, freq = stft.pv_forward(
            self.data, window_size=window_size, hop=hop, dft_size=dft_size,
            sample_rate=float(self.sample_rate))
        return PV(mag=mag, freq=freq, sample_rate=float(self.sample_rate),
                  hop_size=hop, window_size=window_size)

    def convert_to_ms_PV(self, window_size: int = 2048, hop: int = 128,
                         dft_size: int = 4096):
        """Mid-side first, then PV (reference AudioPV.cpp:80-84)."""
        from flan_tpu.pv.pv import PV
        if self.num_channels != 2:
            return PV.create_null()
        return self.convert_to_mid_side().convert_to_PV(window_size, hop,
                                                        dft_size)

    def convert_to_SPV(self, dft_size: int = 1024):
        """Sliding-DFT phase vocoder (reference Conversions/AudioSPV.cpp).
        dft_size is the bin count, as in the reference's call convention."""
        from flan_tpu.spv import SPV, spv_forward
        if self.is_null():
            return SPV.create_null()
        mag, freq = spv_forward(self.data, dft_size,
                                float(self.sample_rate))
        return SPV(mag=mag, freq=freq, sample_rate=float(self.sample_rate))

    def convert_to_ms_SPV(self, dft_size: int = 1024):
        """(reference AudioSPV.cpp:108-111)"""
        return self.convert_to_mid_side().convert_to_SPV(dft_size)

    def convert_to_SQPV(self, bandwidth=(16.0, 24000.0),
                        bins_per_octave: float = 24.0):
        """Sliding constant-Q transform (reference Audio.h:197-205).
        The reference ships this algorithm written but commented out
        (Conversions/AudioSQPV.cpp:64-121, "Sliding With A Constant-Q",
        DAFx-08); here it is activated — see flan_tpu/sqpv/transform.py
        for the modulated-prefix-sum formulation."""
        from flan_tpu.sqpv import SQPV
        from flan_tpu.sqpv.transform import sqpv_forward
        if self.is_null():
            return SQPV.create_null()
        mag, pitch, positive = sqpv_forward(
            self.data, float(self.sample_rate), float(bins_per_octave),
            (float(bandwidth[0]), float(bandwidth[1])))
        return SQPV(mag=mag, pitch=pitch, positive=positive,
                    sample_rate=float(self.sample_rate),
                    bins_per_octave=float(bins_per_octave),
                    bandwidth=(float(bandwidth[0]), float(bandwidth[1])))

    def convert_to_ms_SQPV(self, bandwidth=(16.0, 24000.0),
                           bins_per_octave: float = 24.0):
        """(reference AudioSQPV.cpp:123-126, activated here)."""
        return self.convert_to_mid_side().convert_to_SQPV(
            bandwidth, bins_per_octave)

    def convert_to_mid_side(self) -> "Audio":
        """L/R -> M/S with the reference's 1/sqrt(2) convention
        (reference AudioConversions.cpp:32-51)."""
        if self.is_null():
            return Audio.create_null()
        if self.num_channels != 2:
            return self.copy()
        m = (self.data[0] + self.data[1]) / _SQRT2
        s = (self.data[0] - self.data[1]) / _SQRT2
        return self._with(data=jnp.stack([m, s]))

    def convert_to_left_right(self) -> "Audio":
        """M/S -> L/R; self-inverse (reference AudioConversions.cpp:53-56)."""
        return self.convert_to_mid_side()

    def convert_to_stereo(self) -> "Audio":
        """1 or 2 channels -> 2 (reference AudioConversions.cpp:58-85)."""
        if self.is_null():
            return Audio.create_null()
        if self.num_channels == 2:
            return self.copy()
        if self.num_channels == 1:
            mono = self.data[0] / _SQRT2
            return self._with(data=jnp.stack([mono, mono]))
        raise ValueError(
            f"can't convert {self.num_channels} channels to stereo")

    def convert_to_mono(self) -> "Audio":
        """Average channels (reference AudioConversions.cpp:87-104)."""
        if self.is_null():
            return Audio.create_null()
        mono = jnp.mean(self.data, axis=0, keepdims=True)
        return self._with(data=mono)

    def convert_to_function(self) -> Function:
        """Audio as a Function of time (AudioConversions.cpp:106-123)."""
        if self.is_null():
            return Function(0.0)
        mono = self.convert_to_mono().data[0]
        sr = self.sample_rate
        n = self.num_frames

        def fn(t):
            frame = jnp.asarray(t * sr, jnp.int32)
            valid = (frame >= 0) & (frame < n)
            return jnp.where(valid, mono[jnp.clip(frame, 0, n - 1)], 0.0)

        return Function(fn)

    # =======================================================================
    # Channels (reference Audio.h:237-262, AudioChannels.cpp)
    # =======================================================================
    def split_channels(self) -> List["Audio"]:
        return [self._with(data=self.data[c:c + 1])
                for c in range(self.num_channels)]

    @staticmethod
    def combine_channels(channels: Sequence["Audio"]) -> "Audio":
        """Stack all channels of all inputs (reference AudioChannels.cpp:31).
        Shorter inputs are zero padded to the longest."""
        ins = [a for a in channels if not a.is_null()]
        if not ins:
            return Audio.create_null()
        max_frames = max(a.num_frames for a in ins)
        rows = []
        for a in ins:
            d = a.data
            if a.num_frames < max_frames:
                d = jnp.pad(d, [(0, 0), (0, max_frames - a.num_frames)])
            rows.append(d)
        return Audio(data=jnp.concatenate(rows, axis=0),
                     sample_rate=ins[0].sample_rate)

    # =======================================================================
    # Information (reference Audio.h:266-373)
    # =======================================================================
    def get_total_energy(self) -> np.ndarray:
        """Per-channel sum of squares (reference AudioInformation.cpp)."""
        return np.asarray(jnp.sum(jnp.square(self.data), axis=-1))

    def get_energy_difference(self, other: "Audio") -> np.ndarray:
        """Energy of the per-sample difference; the reference documents this
        as its unit-testing oracle (reference Audio.h:275-279)."""
        n = min(self.num_frames, other.num_frames)
        c = min(self.num_channels, other.num_channels)
        diff = self.data[:c, :n] - other.data[:c, :n]
        return np.asarray(jnp.sum(jnp.square(diff), axis=-1))

    # =======================================================================
    # Basic temporal / volume ops (more in audio/temporal.py, volume.py)
    # =======================================================================
    def reverse(self) -> "Audio":
        """Reverse in time AND channel order (reference
        AudioTemporal.cpp:174-189: channel c is copied forward into
        ``rbegin() + c*F`` of the channel-major flat buffer, so its
        reversed samples land in channel C-1-c — a documented upstream
        quirk, golden-tested in tests/test_algo_golden.py)."""
        return self._with(data=self.data[::-1, ::-1])

    def invert_phase(self) -> "Audio":
        """(reference AudioVolume.cpp)"""
        return self._with(data=-self.data)

    def modify_volume(self, gain) -> "Audio":
        """output(t) = input(t) * gain(t) (reference AudioVolume.cpp:5)."""
        g = as_function(gain)
        if g.is_constant:
            return self._with(data=self.data * g.constant_value)
        t = jnp.arange(self.num_frames, dtype=jnp.float32) / self.sample_rate
        return self._with(data=self.data * g(t)[None, :])

    def set_volume(self, level) -> "Audio":
        """Normalize then scale by level (reference AudioVolume.cpp)."""
        peak = jnp.max(jnp.abs(self.data))
        normalized = self._with(
            data=self.data / jnp.where(peak > 0, peak, 1.0))
        return normalized.modify_volume(level)

    def ring_modulate(self, other: "Audio") -> "Audio":
        """Sample-wise product; shorter inputs wrap cyclically
        (reference AudioVolume.cpp:15-30)."""
        if self.is_null() or other.is_null():
            return Audio.create_null()
        ch = jnp.mod(jnp.arange(self.num_channels), other.num_channels)
        fr = jnp.mod(jnp.arange(self.num_frames), other.num_frames)
        return self._with(data=self.data * other.data[ch][:, fr])

    def get_max_sample_magnitude(self, start_time: float = 0.0,
                                 end_time: float = 0.0) -> float:
        """(reference AudioBuffer.h:164)"""
        if self.is_null():
            return 0.0
        a = self.time_to_frame(start_time)
        b = self.time_to_frame(end_time) if end_time != 0 \
            else self.num_frames
        return float(jnp.max(jnp.abs(self.data[:, a:b])))

    # --- In-place variants --------------------------------------------------
    # The reference offers *_in_place methods to avoid copies
    # (Audio.h:541-592); JAX buffers are immutable and XLA elides copies,
    # so these are parity aliases returning the new object.
    def modify_volume_in_place(self, gain):
        return self.modify_volume(gain)

    def set_volume_in_place(self, level):
        return self.set_volume(level)

    def fade_in_place(self, start=16.0 / 48000.0, end=16.0 / 48000.0,
                      interp=None):
        from flan_tpu.func import interpolators as _i
        return self.fade(start, end, interp or _i.sqrt)

    def fade_frames_in_place(self, start=16, end=16, interp=None):
        from flan_tpu.func import interpolators as _i
        return self.fade_frames(start, end, interp or _i.sqrt)

    def pan_in_place(self, pan_position):
        return self.pan(pan_position)

    def mix_in_place(self, other, other_start_time: float = 0.0,
                     other_amplitude=1.0):
        """(reference AudioCombination.cpp:181-203)"""
        mixed = Audio.mix([self, other],
                          start_times=[0.0, other_start_time],
                          gains=[1.0, other_amplitude])
        # the reference keeps this buffer's length
        return mixed._with(data=mixed.data[:self.num_channels,
                                           :self.num_frames])

    def play(self) -> None:
        """The reference's play() is Windows-only (AudioBuffer.h:220-222);
        here it is unsupported."""
        raise NotImplementedError(
            "Audio.play is not available (the reference supports it only "
            "on win32); save_to_file and play externally")
