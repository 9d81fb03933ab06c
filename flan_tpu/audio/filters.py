"""Audio filter family: VA-design TPT filters, Butterworth cascades,
shelves, multinotch phasers, combs, Hilbert network, frequency shifting.

JAX re-design of the reference's filter translation unit
(reference: src/flan/Audio/AudioFilter.cpp, after "VA Filter Design" 2nd
ed.). Every per-sample loop becomes a parallel scan (flan_tpu.ops.scan /
filter_cores); cascades run stage-sequentially with each stage parallel.
Attached to Audio in flan_tpu.audio.__init__.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func.function import as_function
from flan_tpu.ops.filter_cores import (allpass_1pole_chain, butterworth_poles,
                                       comb_core, onepole_core,
                                       phase_diff_network_poles, svf_core)
from flan_tpu.ops.scan import matrix_affine_recurrence
from flan_tpu.core.types import decibel_to_amplitude


# Constant-coefficient fast path: at or above this length, a filter whose
# parameters are all constants is applied as an FFT convolution of its
# truncated impulse response instead of a state scan. Below it the scan
# is cheap anyway.
_FIR_MIN_FRAMES = 16384


def _is_constant(*params) -> bool:
    for p in params:
        if p is None:
            continue
        if not as_function(p).is_constant:
            return False
    return True


def _const_val(p):
    """Constant value of a parameter already known to be constant."""
    return None if p is None else float(as_function(p).constant_value)


def _fir_fastpath(self, run_direct, cache_key=None):
    """FIR-truncation application of a constant-parameter linear filter.

    run_direct: Audio -> Audio, the filter's ordinary scan path. Returns
    the convolved Audio, or None when the impulse response doesn't decay
    within the signal length (then the scan path is no slower). cache_key
    memoizes the truncated response across calls (ops/fir.py).
    """
    from flan_tpu.ops.fir import fir_apply, impulse_response
    if self.num_frames < _FIR_MIN_FRAMES:
        return None
    h = impulse_response(
        lambda data: run_direct(self._with(data=data)).data,
        max_len=self.num_frames, cache_key=cache_key)
    if h is None:
        return None
    return self._with(data=fir_apply(self.data, jnp.asarray(h)))


def _sample_over_frames(self, f, clamp_cutoff=False):
    fn = as_function(f)
    n = self.num_frames
    if fn.is_constant:
        v = jnp.full((n,), fn.constant_value, jnp.float32)
    else:
        t = jnp.arange(n, dtype=jnp.float32) / self.sample_rate
        v = jnp.broadcast_to(jnp.asarray(fn(t), jnp.float32), (n,))
    if clamp_cutoff:
        v = jnp.clip(v, 1.0, self.sample_rate / 2.0)
    return v


def _g_of(self, w):
    """Prewarped normalized cutoff: g = tan(T/2 * w_hz * 2pi / 2)...
    The reference folds 2pi and the half into T_half = pi/sr
    (AudioFilter.cpp:56-58), so g = tan(T_half * w)."""
    return jnp.tan((math.pi / self.sample_rate) * w)


# ===========================================================================
# 1-pole Butterworth cascades (reference AudioFilter.cpp:326-418)
# ===========================================================================
def _butterworth_1pole(self, order, cutoff, lowpass: bool, _direct=False):
    if not _direct and _is_constant(cutoff):
        key = ("bw1", order, _const_val(cutoff), lowpass, self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_1pole(
            a, order, cutoff, lowpass, _direct=True), cache_key=key)
        if out is not None:
            return out
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    g = _g_of(self, w)
    poles = butterworth_poles(order)
    y = self.data
    if order % 2 == 1:
        lp, hp = onepole_core(y, g[None, :])
        y = lp if lowpass else hp
    for p in poles:
        R = -p.real
        lp, bp, hp = svf_core(y, g[None, :], jnp.float32(R))
        y = lp if lowpass else hp
    return self._with(data=y)


def filter_1pole_lowpass(self, cutoff, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if order == 0:
        return self.copy()
    return _butterworth_1pole(self, order, cutoff, True)


def filter_1pole_highpass(self, cutoff, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if order == 0:
        return self.copy()
    return _butterworth_1pole(self, order, cutoff, False)


def filter_1pole_split(self, cutoff, order: int = 1):
    """Low/high band split (reference AudioFilter.cpp:392-424)."""
    if order <= 1:
        return [filter_1pole_lowpass(self, cutoff, 1),
                filter_1pole_highpass(self, cutoff, 1)]
    lo = filter_1pole_lowpass(
        filter_1pole_lowpass(self, cutoff, order), cutoff, order)
    hi = filter_1pole_highpass(
        filter_1pole_highpass(self, cutoff, order), cutoff, order)
    return [lo, hi]


def filter_1pole_repeat_low(self, cutoff, repeats: int):
    """(reference AudioFilter.cpp:280-323)"""
    y = self
    for _ in range(max(1, repeats)):
        y = filter_1pole_lowpass(y, cutoff, 1)
    return y


def filter_1pole_repeat_high(self, cutoff, repeats: int):
    y = self
    for _ in range(max(1, repeats)):
        y = filter_1pole_highpass(y, cutoff, 1)
    return y


# ===========================================================================
# 1-pole Butterworth shelving (reference AudioFilter.cpp:430-521)
# ===========================================================================
def _butterworth_1pole_tilt(self, order, cutoff, gain_db, _direct=False):
    if not _direct and _is_constant(cutoff, gain_db):
        key = ("bw1t", order, _const_val(cutoff), _const_val(gain_db),
               self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_1pole_tilt(
            a, order, cutoff, gain_db, _direct=True), cache_key=key)
        if out is not None:
            return out
    w0 = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    gain = _sample_over_frames(self, gain_db)
    M = jnp.power(10.0, gain / (2 * order) / 20.0)
    M2 = M * M
    w = M * w0
    g = _g_of(self, w)
    poles = butterworth_poles(order)
    y = self.data
    if order % 2 == 1:
        lp, hp = onepole_core(y, g[None, :])
        y = lp * M[None, :] + hp / M[None, :]
    for p in poles:
        # reference uses R = p.real / w in the tilt variant
        # (AudioFilter.cpp:489); note the sign quirk is preserved
        R = (jnp.float32(p.real) / w)[None, :]
        lp, bp, hp = svf_core(y, g[None, :], R)
        y = lp / M2[None, :] + bp + hp * M2[None, :]
    return self._with(data=y)


def filter_1pole_lowshelf(self, cutoff, gain, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gain_fn = as_function(gain)
    tilt = _butterworth_1pole_tilt(self, max(order, 1), cutoff, gain_fn)
    scale = jnp.power(10.0, _sample_over_frames(self, gain_fn) / 2 / 20.0)
    return tilt._with(data=tilt.data * scale[None, :])


def filter_1pole_highshelf(self, cutoff, gain, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gain_fn = as_function(gain)
    neg = (lambda t: -jnp.asarray(gain_fn(t))) if not gain_fn.is_constant \
        else -gain_fn.constant_value
    tilt = _butterworth_1pole_tilt(self, max(order, 1), cutoff, neg)
    scale = jnp.power(10.0, _sample_over_frames(self, gain_fn) / 2 / 20.0)
    return tilt._with(data=tilt.data * scale[None, :])


# ===========================================================================
# 2-pole Butterworth cascades (reference AudioFilter.cpp:527-624)
# ===========================================================================
def _butterworth_2pole(self, order, cutoff, damping, sel: int,
                       tilt_gain=None, tilt_mode=None, _direct=False):
    if not _direct and _is_constant(cutoff, damping, tilt_gain):
        key = ("bw2", order, _const_val(cutoff), _const_val(damping), sel,
               _const_val(tilt_gain), tilt_mode, self.sample_rate)
        out = _fir_fastpath(self, lambda a: _butterworth_2pole(
            a, order, cutoff, damping, sel, tilt_gain, tilt_mode,
            _direct=True), cache_key=key)
        if out is not None:
            return out
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    R = _sample_over_frames(self, damping)
    poles = butterworth_poles(order)

    if tilt_gain is not None:
        gain = _sample_over_frames(self, tilt_gain)
        M = jnp.power(10.0, gain / (2 * order) / 20.0)
        M2 = M * M
        if tilt_mode in ("low", "high"):
            w = w * M
        elif tilt_mode == "band":
            R = R * M
    else:
        M2 = None

    alpha = jnp.arccos(jnp.clip(R, -1.0, 1.0)) / order
    # pole splitter: R>1 -> real scaling, else complex rotation.
    # Expanded to real/imag components (float32 planes throughout).
    scaler_real = jnp.power(R + jnp.sqrt(jnp.maximum(R * R - 1.0, 0.0)),
                            1.0 / order)
    over = R > 1.0
    sc_re = jnp.where(over, scaler_real, jnp.cos(alpha))
    sc_im = jnp.where(over, 0.0, -jnp.sin(alpha))
    sc_mag2 = sc_re * sc_re + sc_im * sc_im

    def stage_out(lp, bp, hp):
        if tilt_gain is None:
            return [lp, bp, hp][sel]
        if tilt_mode == "low":
            return lp / (M2 * M2)[None, :] + bp / M2[None, :] + hp
        if tilt_mode == "band":
            return lp + bp / M2[None, :] + hp
        return lp + bp * M2[None, :] + hp * (M2 * M2)[None, :]

    y = self.data
    if order % 2 == 1:
        real_R = jnp.cos(alpha)
        lp, bp, hp = svf_core(y, _g_of(self, w)[None, :], real_R[None, :])
        y = stage_out(lp, bp, hp)
    for p in poles:
        pw_re = p.real * w
        pw_im = p.imag * w
        # pole * scaler and pole / scaler (conjugate over |scaler|^2)
        mul = (pw_re * sc_re - pw_im * sc_im,
               pw_re * sc_im + pw_im * sc_re)
        div = ((pw_re * sc_re + pw_im * sc_im) / sc_mag2,
               (pw_im * sc_re - pw_re * sc_im) / sc_mag2)
        for re, im in (mul, div):
            mag = jnp.sqrt(re * re + im * im)
            pr = -re / jnp.maximum(mag, 1e-9)
            lp, bp, hp = svf_core(y, _g_of(self, mag)[None, :],
                                  pr[None, :])
            y = stage_out(lp, bp, hp)
    return self._with(data=y)


def filter_2pole_lowpass(self, cutoff, damping, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 0)


def filter_2pole_bandpass(self, cutoff, damping, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 1)


def filter_2pole_highpass(self, cutoff, damping, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if order == 0:
        return self.copy()
    return _butterworth_2pole(self, order, cutoff, damping, 2)


def filter_2pole_notch(self, cutoff, damping, order: int = 1):
    """input - bandpass (reference AudioFilter.cpp:614-624)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    bp = filter_2pole_bandpass(self, cutoff, damping, order)
    return self._with(data=self.data - bp.data)


def filter_2pole_split(self, cutoff, damping, order: int = 1):
    return [filter_2pole_lowpass(self, cutoff, damping, order),
            filter_2pole_highpass(self, cutoff, damping, order)]


def filter_2pole_lowshelf(self, cutoff, damping, gain, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gain_fn = as_function(gain)
    half = (lambda t: jnp.asarray(gain_fn(t)) / 2.0) \
        if not gain_fn.is_constant else gain_fn.constant_value / 2.0
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=half, tilt_mode="low")


def filter_2pole_bandshelf(self, cutoff, damping, gain, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gain_fn = as_function(gain)
    neg = (lambda t: -jnp.asarray(gain_fn(t))) if not gain_fn.is_constant \
        else -gain_fn.constant_value
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=neg, tilt_mode="band")


def filter_2pole_highshelf(self, cutoff, damping, gain, order: int = 1):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    gain_fn = as_function(gain)
    half = (lambda t: jnp.asarray(gain_fn(t)) / 2.0) \
        if not gain_fn.is_constant else gain_fn.constant_value / 2.0
    return _butterworth_2pole(self, max(order, 1), cutoff, damping, 0,
                              tilt_gain=half, tilt_mode="high")


# ===========================================================================
# Multinotch (allpass phaser with feedback; reference
# AudioFilter.cpp:802-985). The no-saturator path is a linear time-varying
# state space over the N allpass states, solved with a parallel matrix scan;
# the coefficient rows are built by propagating affine forms through the
# cascade symbolically.
# ===========================================================================
def filter_1pole_multinotch(self, order, cutoff, feedback=0.0,
                            invert: bool = False, wet_dry=0.5,
                            use_saturator: bool = False, _direct=False):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if (not _direct and not use_saturator
            and _is_constant(cutoff, feedback, wet_dry)):
        key = ("mn1", order, _const_val(cutoff), _const_val(feedback),
               invert, _const_val(wet_dry), self.sample_rate)
        out = _fir_fastpath(self, lambda a: filter_1pole_multinotch(
            a, order, cutoff, feedback, invert, wet_dry, _direct=True),
            cache_key=key)
        if out is not None:
            return out
    order = max(1, int(order))
    n = self.num_frames
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    k = _sample_over_frames(self, feedback)
    mix = _sample_over_frames(self, wet_dry)
    inv = -1.0 if invert else 1.0

    g = _g_of(self, w)                      # [N]
    G_f = g / (1.0 + g)                      # TPT filter G
    G_ap = (g - 1.0) / (g + 1.0)             # allpass gain
    G_ap_n = jnp.power(G_ap, order)

    if use_saturator:
        return _multinotch_saturator_scan(self, g, G_f, G_ap, k, mix, inv,
                                          order, two_pole=False)

    # affine form of x_bar over [x, s_0..s_{N-1}]
    denom = 1.0 - inv * k * G_ap_n
    cx = 1.0 / denom                         # [N]
    mem_scale = inv * k * (2.0 / (1.0 + g)) * cx
    # s_i coefficient in x_bar: mem_scale * G_ap^(order-1-i)
    s_coeff = jnp.stack([mem_scale * jnp.power(G_ap, order - 1 - i)
                         for i in range(order)], axis=-1)   # [N, order]

    # propagate through the cascade: u_0 = x_bar
    u_cx = cx
    u_cs = s_coeff
    A_rows = []
    b_rows = []
    eye = jnp.eye(order, dtype=jnp.float32)
    for j in range(order):
        # s_j' = 2 G_f u_j + (1 - 2 G_f) s_j
        row = (2.0 * G_f)[:, None] * u_cs + (1.0 - 2.0 * G_f)[:, None] \
            * eye[j][None, :]
        A_rows.append(row)
        b_rows.append(2.0 * G_f * u_cx)
        # y_j = (2 G_f - 1) u_j + 2 (1 - G_f) s_j -> u_{j+1}
        u_cs = (2.0 * G_f - 1.0)[:, None] * u_cs \
            + (2.0 * (1.0 - G_f))[:, None] * eye[j][None, :]
        u_cx = (2.0 * G_f - 1.0) * u_cx

    A = jnp.stack(A_rows, axis=-2)           # [N, order, order]
    b_x = jnp.stack(b_rows, axis=-1)         # [N, order]

    def run_channel(x):
        b = b_x * x[:, None]
        s = matrix_affine_recurrence(A, b, jnp.zeros((order,), jnp.float32))
        s_prev = jnp.concatenate(
            [jnp.zeros((1, order), jnp.float32), s[:-1]], axis=0)
        x_bar = cx * x + jnp.sum(s_coeff * s_prev, axis=-1)
        y_bar = u_cx * x + jnp.sum(u_cs * s_prev, axis=-1)
        return mix * x_bar + (1.0 - mix) * y_bar * inv

    y = jax.vmap(run_channel)(self.data)
    return self._with(data=y)


def filter_2pole_multinotch(self, order, cutoff, damping, feedback=0.0,
                            invert: bool = False, wet_dry=0.5,
                            use_saturator: bool = False, _direct=False):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    if (not _direct and not use_saturator
            and _is_constant(cutoff, damping, feedback, wet_dry)):
        key = ("mn2", order, _const_val(cutoff), _const_val(damping),
               _const_val(feedback), invert, _const_val(wet_dry),
               self.sample_rate)
        out = _fir_fastpath(self, lambda a: filter_2pole_multinotch(
            a, order, cutoff, damping, feedback, invert, wet_dry,
            _direct=True), cache_key=key)
        if out is not None:
            return out
    order = max(1, int(order))
    w = _sample_over_frames(self, cutoff, clamp_cutoff=True)
    k = _sample_over_frames(self, feedback)
    R = _sample_over_frames(self, damping)
    mix = _sample_over_frames(self, wet_dry)
    inv = -1.0 if invert else 1.0

    g = _g_of(self, w)
    d = 1.0 / (1.0 + 2.0 * R * g + g * g)
    G = d * (1.0 - 2.0 * R * g + g * g)      # allpass gain
    G_n = jnp.power(G, order)

    if use_saturator:
        return _multinotch_saturator_scan(self, g, None, G, k, mix, inv,
                                          order, two_pole=True, R=R, d=d)

    nstates = 2 * order
    denom = 1.0 - inv * k * G_n
    cx = 1.0 / denom
    # memory_sum = sum_i G^i (g s2_{N-1-i} - s1_{N-1-i});
    # x_bar = (x + inv k 4 R d msum) / denom
    mcoef = inv * k * 4.0 * R * d * cx
    s_coeff = jnp.zeros((w.shape[0], nstates), jnp.float32)
    for i in range(order):
        j = order - 1 - i
        s_coeff = s_coeff.at[:, 2 * j].add(-mcoef * jnp.power(G, i))
        s_coeff = s_coeff.at[:, 2 * j + 1].add(mcoef * g * jnp.power(G, i))

    g1 = 2.0 * R + g
    gd = g * d
    eye = jnp.eye(nstates, dtype=jnp.float32)

    u_cx = cx
    u_cs = s_coeff
    A_rows = [None] * nstates
    b_rows = [None] * nstates
    for j in range(order):
        e1 = eye[2 * j][None, :]
        e2 = eye[2 * j + 1][None, :]
        # hp = d u - d g1 s1 - d s2
        hp_cs = d[:, None] * u_cs - (d * g1)[:, None] * e1 - d[:, None] * e2
        hp_cx = d * u_cx
        # bp = g hp + s1
        bp_cs = g[:, None] * hp_cs + e1
        bp_cx = g * hp_cx
        # lp = g bp + s2
        lp_cs = g[:, None] * bp_cs + e2
        lp_cx = g * bp_cx
        # s1' = s1 + 2 g hp ; s2' = s2 + 2 g bp
        A_rows[2 * j] = e1 * jnp.ones_like(g)[:, None] \
            + 2.0 * g[:, None] * hp_cs
        b_rows[2 * j] = 2.0 * g * hp_cx
        A_rows[2 * j + 1] = e2 * jnp.ones_like(g)[:, None] \
            + 2.0 * g[:, None] * bp_cs
        b_rows[2 * j + 1] = 2.0 * g * bp_cx
        # allpass out: lp - 2R bp + hp
        u_cs = lp_cs - (2.0 * R)[:, None] * bp_cs + hp_cs
        u_cx = lp_cx - 2.0 * R * bp_cx + hp_cx

    A = jnp.stack(A_rows, axis=-2)
    b_x = jnp.stack(b_rows, axis=-1)

    def run_channel(x):
        b = b_x * x[:, None]
        s = matrix_affine_recurrence(A, b,
                                     jnp.zeros((nstates,), jnp.float32))
        s_prev = jnp.concatenate(
            [jnp.zeros((1, nstates), jnp.float32), s[:-1]], axis=0)
        x_bar = cx * x + jnp.sum(s_coeff * s_prev, axis=-1)
        y_bar = u_cx * x + jnp.sum(u_cs * s_prev, axis=-1)
        return mix * x_bar + (1.0 - mix) * y_bar * inv

    y = jax.vmap(run_channel)(self.data)
    return self._with(data=y)


def _multinotch_saturator_scan(self, g, G_f, G_ap, k, mix, inv, order,
                               two_pole, R=None, d=None):
    """Sequential fallback for the tanh-feedback saturator variant
    (reference AudioFilter.cpp:866-890): per-sample Newton iterations make
    the recurrence nonlinear, so it runs as lax.scan."""
    n = self.num_frames

    if two_pole:
        def step(carry, inputs):
            s, prev_y = carry  # s: [C, order, 2]
            x, g_c, G_c, k_c, mix_c, R_c, d_c = inputs
            msum = jnp.zeros_like(x)
            for i in range(order):
                j = order - 1 - i
                msum = msum + (G_c ** i) * (g_c * s[:, j, 1] - s[:, j, 0])
            Gn = G_c ** order

            u = prev_y
            for _ in range(8):
                tanh_c = jnp.tanh(k_c * (Gn * u + msum))
                den = inv * (1 - tanh_c ** 2) * k_c * Gn - 1.0
                den = jnp.where(jnp.abs(den) < 1e-6, 1.0, den)
                u = u - (x + inv * tanh_c - u) / den
            x_bar = u

            y = x_bar
            new_s = []
            for j in range(order):
                g1 = 2 * R_c + g_c
                hp = (y - g1 * s[:, j, 0] - s[:, j, 1]) * d_c
                v1 = g_c * hp
                bp = v1 + s[:, j, 0]
                s1n = bp + v1
                v2 = g_c * bp
                lp = v2 + s[:, j, 1]
                s2n = lp + v2
                new_s.append(jnp.stack([s1n, s2n], axis=-1))
                y = lp - bp * 2 * R_c + hp
            y = y * inv
            out = mix_c * x_bar + (1 - mix_c) * y
            return (jnp.stack(new_s, axis=1), out), out

        init = (jnp.zeros((self.num_channels, order, 2), jnp.float32),
                jnp.zeros((self.num_channels,), jnp.float32))
        xs = (self.data.T, g, G_ap, k, mix, R, d)
        _, ys = jax.lax.scan(step, init, xs)
        return self._with(data=ys.T)

    def step(carry, inputs):
        s, prev_y = carry  # s: [C, order]
        x, g_c, Gf_c, Gap_c, k_c, mix_c = inputs
        msum = jnp.zeros_like(x)
        for i in range(order):
            msum = msum + (Gap_c ** i) * s[:, order - 1 - i]
        msum = msum * 2.0 / (1.0 + g_c)
        Gn = Gap_c ** order

        u = prev_y
        for _ in range(8):
            tanh_c = jnp.tanh(k_c * (Gn * u + msum))
            den = inv * (1 - tanh_c ** 2) * k_c * Gn - 1.0
            den = jnp.where(jnp.abs(den) < 1e-6, 1.0, den)
            u = u - (x + inv * tanh_c - u) / den
        x_bar = u

        y = x_bar
        new_s = []
        for j in range(order):
            v = Gf_c * (y - s[:, j])
            lp = v + s[:, j]
            new_s.append(lp + v)
            y = 2 * lp - y  # allpass = lp - hp
        y = y * inv
        out = mix_c * x_bar + (1 - mix_c) * y
        return (jnp.stack(new_s, axis=1), out), out

    init = (jnp.zeros((self.num_channels, order), jnp.float32),
            jnp.zeros((self.num_channels,), jnp.float32))
    xs = (self.data.T, g, G_f, G_ap, k, mix)
    _, ys = jax.lax.scan(step, init, xs)
    return self._with(data=ys.T)


# ===========================================================================
# Comb (reference AudioFilter.cpp:988-1045)
# ===========================================================================
def filter_comb(self, cutoff, feedback=0.0, wet_dry=0.5,
                invert: bool = False):
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    cut_fn = as_function(cutoff)
    k = _sample_over_frames(self, feedback)
    a = _sample_over_frames(self, wet_dry)
    if cut_fn.is_constant:
        w = float(np.clip(cut_fn.constant_value, 1.0,
                          self.sample_rate / 2.0))
        delay = self.time_to_frame(1.0 / (2.0 * w))
        y = comb_core(self.data, delay, k, invert, a)
        return self._with(data=y)
    # time-varying delay: sequential ring-buffer scan
    w = _sample_over_frames(self, cut_fn, clamp_cutoff=True)
    delays = jnp.clip((self.sample_rate / (2.0 * w)).astype(jnp.int32),
                      1, self.num_frames)
    max_delay = int(jnp.max(delays))
    f = -1.0 if invert else 1.0

    def step(carry, inputs):
        buf, pos = carry  # buf: [C, max_delay]
        x, dly, k_c, a_c = inputs
        read = jnp.mod(pos - dly, max_delay)
        u_del = buf[:, read]
        u = x + k_c * f * u_del
        buf = buf.at[:, pos].set(u)
        y = a_c * u + (1 - a_c) * f * u_del
        return (buf, jnp.mod(pos + 1, max_delay)), y

    init = (jnp.zeros((self.num_channels, max_delay), jnp.float32),
            jnp.asarray(0, jnp.int32))
    _, ys = jax.lax.scan(step, init, (self.data.T, delays, k, a))
    return self._with(data=ys.T)


# ===========================================================================
# Hilbert network / frequency shift (reference AudioFilter.cpp:1047-1262)
# ===========================================================================
def _hilbert_pair(self):
    """Approximate analytic signal via two 1-pole allpass cascades
    (90-degree phase differencing network; AudioFilter.cpp:1162-1171)."""
    poles_a, poles_b = phase_diff_network_poles(20, 5.0, 22000.0)
    # the reference's multi-allpass path skips prewarping
    # (process_sample(..., use_prewarp=false)): g = w * T_half with
    # T_half = pi/sr, fed the design's rad/s pole values directly
    # (AudioFilter.cpp:1066) - preserved as-is for parity.
    T_half = math.pi / self.sample_rate
    gs_a = [p * T_half for p in poles_a]
    gs_b = [p * T_half for p in poles_b]
    if self.num_frames >= _FIR_MIN_FRAMES:
        # the 2x20-pole allpass cascades have fixed coefficients, so both
        # run as truncated-FIR convolutions (see _fir_fastpath)
        from flan_tpu.ops.fir import fir_apply, impulse_response
        hs = [impulse_response(lambda d, gs=gs: allpass_1pole_chain(d, gs),
                               max_len=self.num_frames,
                               cache_key=("hilbert", side, self.sample_rate))
              for side, gs in enumerate((gs_a, gs_b))]
        if all(h is not None for h in hs):
            return (fir_apply(self.data, jnp.asarray(hs[0])),
                    fir_apply(self.data, jnp.asarray(hs[1])))
    re = allpass_1pole_chain(self.data, gs_a)
    im = allpass_1pole_chain(self.data, gs_b)
    return re, im


def halfband_modulate(self, modulator):
    """Multiply the analytic signal by a complex modulator
    (reference AudioFilter.cpp:1173-1197). The modulator may return a
    complex array or a (real, imag) tuple; components are used separately
    (large 1-D complex arithmetic is unimplemented on this backend)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    re, im = _hilbert_pair(self)
    t = jnp.arange(self.num_frames, dtype=jnp.float32) / self.sample_rate
    fn = as_function(modulator) if not callable(modulator) else modulator
    m = fn(t) if callable(fn) else (fn.constant_value, 0.0)
    if isinstance(m, tuple):
        m_re = jnp.broadcast_to(jnp.asarray(m[0], jnp.float32),
                                (self.num_frames,))
        m_im = jnp.broadcast_to(jnp.asarray(m[1], jnp.float32),
                                (self.num_frames,))
    else:
        m = jnp.asarray(m)
        m_re = jnp.real(m).astype(jnp.float32)
        m_im = (jnp.imag(m).astype(jnp.float32)
                if jnp.iscomplexobj(m) else jnp.zeros_like(m_re))
        m_re = jnp.broadcast_to(m_re, (self.num_frames,))
        m_im = jnp.broadcast_to(m_im, (self.num_frames,))
    out = re * m_re[None, :] - im * m_im[None, :]
    return self._with(data=out.astype(jnp.float32))


def shift_frequency(self, shift, low_cutoff: float = 30.0):
    """Single-sideband frequency shift via the Hilbert network
    (reference AudioFilter.cpp:1199-1238)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null():
        return Audio.create_null()
    high_cutoff = self.sample_rate / 2.0 - 1000.0
    shift_fn = as_function(shift)
    s = _sample_over_frames(self, shift_fn)

    if shift_fn.is_constant:
        # constant shift -> constant antialias cutoffs, which lets the
        # 8-pole cascades take the FIR-convolution fast path
        sc = float(shift_fn.constant_value)
        lp_c = high_cutoff - sc if sc > 0 else high_cutoff
        hp_c = low_cutoff - sc if sc < 0 else low_cutoff
        antialiased = filter_1pole_highpass(
            filter_1pole_lowpass(self, lp_c, 8), hp_c, 8)
    else:
        lp_cut = jnp.where(s > 0, high_cutoff - s, high_cutoff)
        hp_cut = jnp.where(s < 0, low_cutoff - s, low_cutoff)
        antialiased = filter_1pole_lowpass(
            self, lambda t: jnp.asarray(lp_cut)[jnp.clip(
                (t * self.sample_rate).astype(jnp.int32), 0,
                self.num_frames - 1)], 8)
        antialiased = filter_1pole_highpass(
            antialiased, lambda t: jnp.asarray(hp_cut)[jnp.clip(
                (t * self.sample_rate).astype(jnp.int32), 0,
                self.num_frames - 1)], 8)

    # exclusive mod-1 cycle accumulation (float32-safe for long audio)
    cycles = jnp.mod(s / self.sample_rate, 1.0)
    acc = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(cycles)[:-1]])
    phase = jnp.mod(acc, 1.0) * (2.0 * jnp.pi)

    def modulator(t):
        idx = jnp.clip((t * self.sample_rate).astype(jnp.int32), 0,
                       self.num_frames - 1)
        return (jnp.cos(phase[idx]), jnp.sin(phase[idx]))

    return halfband_modulate(antialiased, modulator)


def halfband_multiply(self, modulator):
    """Analytic-signal product of two audios
    (reference AudioFilter.cpp:1240-1262)."""
    from flan_tpu.audio.audio import Audio
    if self.is_null() or modulator.is_null():
        return Audio.create_null()

    def bandpass(a):
        return filter_1pole_highpass(
            filter_1pole_lowpass(a, a.sample_rate / 2 - 2000.0, 8),
            30.0, 8)

    a_re, a_im = _hilbert_pair(bandpass(self))
    b_re, b_im = _hilbert_pair(bandpass(modulator))
    c = min(self.num_channels, modulator.num_channels)
    n = min(self.num_frames, modulator.num_frames)
    out = (a_re[:c, :n] * b_re[:c, :n] - a_im[:c, :n] * b_im[:c, :n])
    return self._with(data=out)
