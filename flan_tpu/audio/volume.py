"""Audio volume/dynamics: waveshape, compressor, ADSR, moisture.

JAX re-design of the reference's volume family
(reference: src/flan/Audio/AudioVolume.cpp). The compressor's sequential
peak detector becomes two associative scans (flan_tpu.ops.scan). Attached to
Audio in flan_tpu.audio.__init__.
"""
from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import adsr as adsr_fn, as_function
from flan_tpu.ops.scan import linear_recurrence, max_affine_recurrence


def waveshape(self, shaper, oversample_factor: int = 4):
    """Apply shaper(t, sample) at an oversampled rate to reduce aliasing
    (reference AudioVolume.cpp:146-166)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    over = self if oversample_factor <= 1 else self.resample(
        self.sample_rate * oversample_factor)
    t = jnp.arange(over.num_frames, dtype=jnp.float32) / over.sample_rate
    shaped = shaper(t[None, :], over.data)
    shaped = over._with(data=jnp.asarray(shaped, jnp.float32))
    if oversample_factor <= 1:
        return shaped
    return shaped.resample(self.sample_rate)


def add_moisture(self, amount=0.5, frequency=96.0, skew=4.0,
                 waveform=None):
    """Bass 'moisture' effect via skew-powered waveform shaping
    (reference AudioVolume.cpp:168-188)."""
    from flan_tpu.func.function import waveforms
    if waveform is None:
        waveform = waveforms.sine
    amount_fn = as_function(amount)
    freq_fn = as_function(frequency)
    skew_fn = as_function(skew)

    def shaper(t, s):
        a = jnp.asarray(amount_fn(t), jnp.float32)
        f = jnp.asarray(freq_fn(t), jnp.float32)
        k = jnp.asarray(skew_fn(t), jnp.float32)
        power = jnp.sign(s) * jnp.power(jnp.abs(s), k)
        return s + a * s * waveform(2.0 * jnp.pi * f * power)

    return waveshape(self, shaper)


def compress(self, threshold, ratio=3.0, attack=0.005, release=0.1,
             knee_width=0.0, sidechain_source=None):
    """Feed-forward dynamic range compressor, Giannoulis et al. design
    (reference AudioVolume.cpp:190-278): soft-knee gain computer + smooth
    decoupled peak detector. The detector's two recurrences run as
    associative scans instead of the reference's per-sample loop."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    source = sidechain_source if sidechain_source is not None else self
    n = self.num_frames
    sr = self.sample_rate

    # control signal: per-frame max over channels (AudioVolume.cpp:210-215).
    # The reference accumulates into a zero-initialized buffer with
    # `if (channel_max[f] < sample)` on SIGNED samples, so the detector
    # sees max(0, max_c x) — negative half-waves detect as silence. Quirk
    # preserved (golden-tested vs the compiled reference).
    x = jnp.maximum(jnp.max(source.data, axis=0), 0.0)
    if x.shape[0] < n:
        x = jnp.pad(x, (0, n - x.shape[0]))
    x = x[:n]

    t = jnp.arange(n, dtype=jnp.float32) / sr

    def samp(f):
        fn = as_function(f)
        if fn.is_constant:
            return jnp.full((n,), fn.constant_value, jnp.float32)
        return jnp.broadcast_to(jnp.asarray(fn(t), jnp.float32), (n,))

    thresh = samp(threshold)
    ratio_s = jnp.maximum(samp(ratio), 1e-6)
    attack_s = samp(attack)
    release_s = samp(release)
    knee = samp(knee_width)

    # gain computer (4) with soft knee
    x_G = 20.0 * jnp.log10(jnp.maximum(jnp.abs(x), 1e-6))
    overshoot = x_G - thresh
    slope = 1.0 / ratio_s - 1.0
    z = overshoot + knee / 2.0
    in_knee = jnp.where(knee > 0.0,
                        x_G + slope * z * z / (2.0 * jnp.maximum(knee,
                                                                 1e-9)),
                        x_G)
    y_G = jnp.where(overshoot <= -knee / 2.0, x_G,
                    jnp.where(overshoot >= knee / 2.0,
                              x_G + overshoot * slope, in_knee))
    x_L = x_G - y_G

    # smooth decoupled peak detector (17) as two parallel scans
    a_R = jnp.exp(-1.0 / (jnp.maximum(release_s, 1e-9) * sr))
    a_A = jnp.exp(-1.0 / (jnp.maximum(attack_s, 1e-9) * sr))
    y_1 = max_affine_recurrence(x_L, a_R, (1.0 - a_R) * x_L, y0=0.0)
    y_L = linear_recurrence(a_A, (1.0 - a_A) * y_1, y0=0.0)

    c = jnp.power(10.0, -y_L / 20.0)
    return self._with(data=self.data * c[None, :])


def apply_adsr_envelope(self, attack_time, decay_time, sustain_time,
                        release_time, sustain_level, attack_exponent=1.0,
                        decay_exponent=1.0, release_exponent=1.0):
    """(reference AudioVolume.cpp:280-301)"""
    env = adsr_fn(attack_time, decay_time, sustain_time, release_time,
                  sustain_level, attack_exponent, decay_exponent,
                  release_exponent)
    return self.modify_volume(env)


def apply_ar_envelope(self, attack_time, release_time,
                      attack_exponent=1.0, release_exponent=1.0):
    """(reference AudioVolume.cpp:304-321)"""
    return apply_adsr_envelope(self, attack_time, 0.0, 0.0, release_time,
                               1.0, attack_exponent, 1.0, release_exponent)
