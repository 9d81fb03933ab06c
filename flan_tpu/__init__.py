"""flan_tpu: an audio processing framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of the reference
Flan library (phase-vocoder-centric offline audio processing). The compute
path is batched tensor programs on the accelerator (an NVIDIA GPU); see
SURVEY.md for the layer map.
"""
from flan_tpu.core.audio_buffer import AudioBuffer, AudioFormat, SndfileStrings
from flan_tpu.core.pv_buffer import PVBuffer, PVFormat
from flan_tpu.audio import Audio
from flan_tpu.pv import PV
from flan_tpu.spv import SPV
from flan_tpu.sqpv import SQPV
from flan_tpu.wavetable import PitchMode, SnapMode, Wavetable
from flan_tpu.graph import Graph, WaveformMode
from flan_tpu.utils.geometry import Color, Interval, Rect, View
from flan_tpu.func.function import (Function, Function2d, adsr, as_function,
                                    as_function2d, waveforms)
from flan_tpu.func import interpolators
from flan_tpu.func.function_sample import FunctionSample, FunctionSample2d
from flan_tpu.func.pipe import Pipe
from flan_tpu.spectrum import Spectrum

__version__ = "0.1.0"

__all__ = [
    "Audio", "AudioBuffer", "AudioFormat", "SndfileStrings",
    "PV", "PVBuffer", "PVFormat", "SPV", "SQPV",
    "Wavetable", "SnapMode", "PitchMode",
    "Graph", "WaveformMode", "Color", "Interval", "Rect", "View",
    "FunctionSample", "FunctionSample2d", "Pipe", "Spectrum",
    "Function", "Function2d", "adsr", "as_function", "as_function2d",
    "waveforms", "interpolators",
]
