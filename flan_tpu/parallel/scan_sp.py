"""Sequence-parallel IIR recurrences: boundary-state handoff over a mesh.

Closes the SURVEY.md section 5 item the STFT pair doesn't cover: IIR
filter scans whose state crosses shard edges. The reference runs these as per-sample CPU loops
(src/flan/Audio/AudioFilter.cpp:61-186); single-chip we run them as
tiled associative scans (flan_tpu.ops.scan); across chips the same
composed-map algebra gives an O(1)-collective split:

1. each device scans its local span with an UNKNOWN initial state,
   producing the composed prefix maps (aa, bb): y[t] = aa[t]*y_in + bb[t]
2. one `all_gather` of the tiny per-shard total maps ([devices, C] scalars
   or [devices, C, k, k] matrices - bytes, not samples)
3. every device folds its predecessors' total maps over y0 (a static
   d-step loop over registers) to recover its true boundary state
4. the local correction is one fused multiply-add: aa * y_start + bb

No sequential cross-device pass, no halo: the recurrence's entire global
coupling is the gathered map totals.

Run under `jax.shard_map` on a 1-D mesh; validated against the
single-chip recurrences in tests/test_multichip.py and the driver's
dryrun (__graft_entry__.dryrun_multichip).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from flan_tpu.ops.scan import (linear_scanned_maps,
                               matrix_affine_scanned_leaves)
from flan_tpu.ops.stft import _cdiv


def linear_recurrence_sp(a: jnp.ndarray, b: jnp.ndarray, mesh: Mesh,
                         y0=0.0, axis_name: str = "sp") -> jnp.ndarray:
    """y[n] = a[n] * y[n-1] + b[n] with the time axis sharded.

    a, b: [C, N] (a broadcastable to b); y0: scalar or [C]. Pads N to a
    multiple of the mesh size with identity maps (a=1, b=0) and slices the
    padding back off.
    """
    a = jnp.broadcast_to(a, b.shape).astype(b.dtype)
    c, n = b.shape
    d = mesh.shape[axis_name]
    n_pad = _cdiv(n, d) * d
    ap = jnp.pad(a, [(0, 0), (0, n_pad - n)], constant_values=1.0)
    bp = jnp.pad(b, [(0, 0), (0, n_pad - n)])
    y0v = jnp.broadcast_to(jnp.asarray(y0, b.dtype), (c,))

    def kernel(a_l, b_l):
        aa, bb = linear_scanned_maps(a_l, b_l)          # [C, n_local]
        ga = jax.lax.all_gather(aa[:, -1], axis_name)   # [d, C]
        gb = jax.lax.all_gather(bb[:, -1], axis_name)
        idx = jax.lax.axis_index(axis_name)
        s = y0v
        for i in range(d - 1):                          # static, tiny
            s = jnp.where(i < idx, ga[i] * s + gb[i], s)
        return aa * s[:, None] + bb

    fn = shard_map(kernel, mesh=mesh,
                   in_specs=(P(None, axis_name), P(None, axis_name)),
                   out_specs=P(None, axis_name))
    return fn(ap, bp)[:, :n]


def matrix_affine_recurrence_sp(A: jnp.ndarray, b: jnp.ndarray,
                                y0: jnp.ndarray, mesh: Mesh,
                                axis_name: str = "sp") -> jnp.ndarray:
    """y[t] = A[t] @ y[t-1] + b[t] with the T axis sharded.

    A: [C, T, k, k], b: [C, T, k], y0: [C, k] (k = 2 for the 2-pole SVF
    state). Pads T to a multiple of the mesh size with identity maps.
    """
    c, t, k, _ = A.shape
    d = mesh.shape[axis_name]
    t_pad = _cdiv(t, d) * d
    if t_pad != t:
        eye = jnp.broadcast_to(jnp.eye(k, dtype=b.dtype),
                               (c, t_pad - t, k, k))
        A = jnp.concatenate([A, eye], axis=1)
        b = jnp.pad(b, [(0, 0), (0, t_pad - t), (0, 0)])
    y0 = jnp.asarray(y0, b.dtype)

    def kernel(A_l, b_l):
        leaves = matrix_affine_scanned_leaves(A_l, b_l)  # k*k+k of [C, T_l]
        AA = leaves[: k * k]
        bb = leaves[k * k:]
        tot_a = jnp.stack(
            [jnp.stack([AA[i * k + j][:, -1] for j in range(k)], axis=-1)
             for i in range(k)], axis=-2)               # [C, k, k]
        tot_b = jnp.stack([bb[i][:, -1] for i in range(k)], axis=-1)
        ga = jax.lax.all_gather(tot_a, axis_name)       # [d, C, k, k]
        gb = jax.lax.all_gather(tot_b, axis_name)
        idx = jax.lax.axis_index(axis_name)
        s = y0                                          # [C, k]
        for i in range(d - 1):
            # HIGHEST: the reduced-precision default (TF32 on GPUs)
            # would round the boundary state handed to every later shard
            nxt = jnp.einsum("cij,cj->ci", ga[i], s,
                             precision=jax.lax.Precision.HIGHEST) + gb[i]
            s = jnp.where(i < idx, nxt, s)
        y = jnp.stack([
            sum(AA[i * k + m] * s[:, m, None] for m in range(k)) + bb[i]
            for i in range(k)], axis=-1)                # [C, T_l, k]
        return y

    fn = shard_map(
        kernel, mesh=mesh,
        in_specs=(P(None, axis_name, None, None), P(None, axis_name, None)),
        out_specs=P(None, axis_name, None))
    return fn(A, b)[:, :t]


def filter_1pole_lowpass_sp(x: jnp.ndarray, cutoff, sample_rate: float,
                            mesh: Mesh,
                            axis_name: str = "sp") -> jnp.ndarray:
    """Sequence-parallel TPT 1-pole lowpass, mirroring
    flan_tpu.ops.filter_cores.onepole_core exactly (reference
    Filter_1Pole::process_sample, AudioFilter.cpp:61-74): the worked
    example of linear_recurrence_sp on a real filter, for time-varying
    cutoffs where the constant-coefficient FIR fast path doesn't apply.

    x: [C, N]; cutoff: Hz scalar or [N] array (per-sample).
    """
    # g = tan(pi/sr * cutoff_hz): the reference folds 2pi and the half
    # into T_half = pi/sr (AudioFilter.cpp:56-58, audio/filters.py _g_of)
    g = jnp.tan((jnp.pi / sample_rate) * jnp.broadcast_to(
        jnp.asarray(cutoff, jnp.float32), (x.shape[-1],)))
    big_g = (g / (1.0 + g))[None, :]
    s = linear_recurrence_sp(1.0 - 2.0 * big_g, 2.0 * big_g * x,
                             mesh, 0.0, axis_name)
    s_prev = jnp.concatenate([jnp.zeros_like(s[:, :1]), s[:, :-1]], axis=-1)
    return big_g * x + (1.0 - big_g) * s_prev
