"""TPT (topology-preserving transform) filter cores as parallel scans.

JAX re-design of the reference's per-sample VA filter loops
(reference: src/flan/Audio/AudioFilter.cpp:50-238, after "VA Filter Design"
2nd ed.). The reference runs strictly sequential sample loops; here each
filter's state recurrence is linear time-varying, so it runs as an
associative scan (flan_tpu.ops.scan) in O(log n) depth:

* 1-pole TPT: s[n] = (1-2G[n]) s[n-1] + 2G[n] x[n]    (scalar affine scan)
* 2-pole TPT SVF: (s1,s2) 2x2 matrix affine scan
* chains (Butterworth cascades, allpass networks) run stage-sequentially,
  each stage a parallel scan.

All cores take g = prewarped-cutoff * T_half per frame and operate on
[..., N] arrays, vectorized over channels.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.ops.scan import linear_recurrence, matrix_affine_recurrence


def prewarp(w, T_half):
    """Bilinear-transform frequency prewarping: tan(T/2 w)/(T/2)
    (reference AudioFilter.cpp:19-30)."""
    return jnp.tan(T_half * w) / T_half


def _shift_right(s, axis=-1):
    """[s0, s1, ...] -> [0, s0, s1, ...] dropping the last element."""
    pad = [(0, 0)] * s.ndim
    pad[axis] = (1, 0)
    return jnp.pad(s, pad)[..., :-1] if axis in (-1, s.ndim - 1) else None


def onepole_core(x: jnp.ndarray, g: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-pole TPT filter (reference Filter_1Pole::process_sample,
    AudioFilter.cpp:61-74). x: [..., N], g: [N] or [..., N] (already
    prewarped * T_half). Returns (lowpass, highpass)."""
    G = g / (1.0 + g)
    G = jnp.broadcast_to(G, x.shape)
    s = linear_recurrence(1.0 - 2.0 * G, 2.0 * G * x)
    s_prev = _shift_right(s)
    lp = G * x + (1.0 - G) * s_prev
    return lp, x - lp


def svf_core(x: jnp.ndarray, g: jnp.ndarray, R: jnp.ndarray
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """2-pole TPT state-variable filter (reference
    Filter_2Pole::process_sample, AudioFilter.cpp:164-186).

    x: [..., N]; g, R: broadcastable to x (g prewarped * T_half).
    Returns (lp, bp_normalized, hp) where bp_normalized = bp * 2R, matching
    the reference's output triple.
    """
    g = jnp.broadcast_to(g, x.shape)
    R = jnp.broadcast_to(R, x.shape)
    g1 = 2.0 * R + g
    d = 1.0 / (1.0 + 2.0 * R * g + g * g)

    # state transition for (s1, s2):
    # s1' = (1 - 2 g d g1) s1 - 2 g d s2 + 2 g d x
    # s2' = 2 g (1 - g d g1) s1 + (1 - 2 g^2 d) s2 + 2 g^2 d x
    gd = g * d
    a11 = 1.0 - 2.0 * gd * g1
    a12 = -2.0 * gd
    a21 = 2.0 * g * (1.0 - gd * g1)
    a22 = 1.0 - 2.0 * g * gd
    b1 = 2.0 * gd * x
    b2 = 2.0 * g * gd * x

    A = jnp.stack([jnp.stack([a11, a12], axis=-1),
                   jnp.stack([a21, a22], axis=-1)], axis=-2)  # [..., N, 2, 2]
    b = jnp.stack([b1, b2], axis=-1)                           # [..., N, 2]
    y0 = jnp.zeros(x.shape[:-1] + (2,), x.dtype)
    s = matrix_affine_recurrence(A, b, y0)                     # [..., N, 2]
    s1_prev = _shift_right(s[..., 0])
    s2_prev = _shift_right(s[..., 1])

    hp = (x - g1 * s1_prev - s2_prev) * d
    bp = g * hp + s1_prev
    lp = g * bp + s2_prev
    return lp, bp * 2.0 * R, hp


def allpass_1pole_chain(x: jnp.ndarray, gs: Sequence[float]) -> jnp.ndarray:
    """Cascade of 1-pole allpasses (lp - hp) at fixed cutoffs g_i
    (reference filter_1pole_multi_allpass, AudioFilter.cpp:1047-1074).
    No prewarping, matching the reference's use_prewarp=false call."""
    y = x
    for g in gs:
        lp, hp = onepole_core(y, jnp.asarray(g, x.dtype))
        y = lp - hp
    return y


def comb_core(x: jnp.ndarray, delay_frames: int, k: jnp.ndarray,
              invert: bool, wet_dry: jnp.ndarray) -> jnp.ndarray:
    """Feedback comb with constant integer delay t
    (reference Audio::filter_comb, AudioFilter.cpp:988-1045):
        u[n] = x[n] + k f u[n-t];  y[n] = a u[n] + (1-a) f u[n-t]

    The lag-t recurrence splits into t independent lag-1 chains (phase
    decomposition), each solved with a parallel scan.
    """
    f = -1.0 if invert else 1.0
    c = x.shape[0]
    n = x.shape[-1]
    t = max(1, int(delay_frames))
    npad = (-n) % t
    xp = jnp.pad(x, [(0, 0), (0, npad)])
    k = jnp.broadcast_to(k, x.shape)
    kp = jnp.pad(k, [(0, 0), (0, npad)])
    blocks = n + npad
    # reshape to [C, blocks/t, t]: consecutive rows are lag-t neighbors
    xr = xp.reshape(c, blocks // t, t)
    kr = kp.reshape(c, blocks // t, t)
    u = linear_recurrence(f * kr, xr, axis=1)
    u_flat = u.reshape(c, blocks)[:, :n]
    u_delayed = jnp.pad(u_flat, [(0, 0), (t, 0)])[:, :n]
    a = jnp.broadcast_to(wet_dry, x.shape)
    return a * u_flat + (1.0 - a) * f * u_delayed


def butterworth_poles(order: int) -> List[complex]:
    """Upper-half-plane Butterworth poles of unit cutoff
    (reference generate_butterworth_type1_poles, AudioFilter.cpp:32-44)."""
    poles = []
    for i in range(order // 2):
        delta = math.pi / order
        theta = delta * i + math.pi / 2.0 + delta / 2.0
        poles.append(complex(math.cos(theta), math.sin(theta)))
    return poles


def phase_diff_network_poles(num_poles: int = 20, lower: float = 5.0,
                             upper: float = 22000.0
                             ) -> Tuple[List[float], List[float]]:
    """90-degree phase differencing network pole frequencies.

    Elliptic-approximation design after the Electronotes EN-168 method the
    reference follows (AudioFilter.cpp:1109-1160). Returns the two allpass
    cascades' pole frequencies (odd-indexed, even-indexed), in the same
    swapped order as the reference.
    """
    B = upper / lower
    kk = math.sqrt(1.0 - 1.0 / (B * B))
    L = 0.5 * (1.0 - math.sqrt(kk)) / (1.0 + math.sqrt(kk))
    A_p = L + 2.0 * L ** 5 + 15.0 * L ** 9
    A = math.exp(math.pi * math.pi / math.log(A_p))
    n = num_poles
    phi = [math.pi / 4.0 / n * (2 * r - 1) for r in range(1, n + 1)]
    phi_p = []
    for ph in phi:
        numer = (A ** 2 - A ** 6) * math.sin(4.0 * ph)
        denom = 1.0 + (A ** 2 + A ** 6) * math.cos(4.0 * ph)
        phi_p.append(math.atan(numer / denom))
    p = [math.sqrt(B) * math.tan(ph - php) * 2.0 * math.pi * lower
         for ph, php in zip(phi, phi_p)]
    p_a = [p[r] for r in range(len(p)) if r % 2 == 0]
    p_b = [p[r] for r in range(len(p)) if r % 2 == 1]
    return p_b, p_a
