"""Parallel recurrence solvers (associative scans).

The reference's per-sample IIR loops (filters AudioFilter.cpp:61-186,
compressor peak detector AudioVolume.cpp:246-253, resonate PV.cpp:602) are
strictly sequential on CPU. On the device every one of them is an
associative scan:

* first-order linear y[n] = a[n] y[n-1] + b[n]  -> affine-map composition
* the compressor's max-smoother y[n] = max(m[n], a[n] y[n-1] + c[n])
  -> the class {y -> max(m, a y + c)} is closed under composition
* k-dim state recurrences (2-pole SVF, allpass cascades) -> small-matrix
  affine composition

All run in O(log n) depth via jax.lax.associative_scan, vectorized over
channels/bins.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Block length for the two-level (tiled) scans. Long scans are reshaped to
# [..., nblocks, BLOCK] and solved as one within-block associative scan
# plus a tiny cross-block scan: every intermediate shape is then uniform
# and power-of-2 along the scanned axis (a single associative_scan over an
# arbitrary ~10^5+ length generates deep odd/even slicing; whether the
# card needs the tiling is an open question).
BLOCK = 4096


def _hillis_steele_scan(combine, identity, elems, axis: int = -1):
    """Inclusive scan via shift-and-combine doubling steps.

    O(n log n) work but every memory op is a contiguous pad/slice, where
    jax.lax.associative_scan's odd/even recursion emits stride-2 slices.
    All device scans route through this form.
    """
    leaves = jax.tree_util.tree_leaves(elems)
    n = leaves[0].shape[axis]

    def shift(x, d, ident):
        pad = [(0, 0)] * x.ndim
        pad[axis if axis >= 0 else x.ndim + axis] = (d, 0)
        sl = [slice(None)] * x.ndim
        sl[axis if axis >= 0 else x.ndim + axis] = slice(0, x.shape[axis])
        return jnp.pad(x, pad, constant_values=ident)[tuple(sl)]

    d = 1
    while d < n:
        shifted = jax.tree_util.tree_map(
            lambda x, ident: shift(x, d, ident), elems, identity)
        elems = combine(shifted, elems)
        d *= 2
    return elems


def _tiled_scan(combine, identity, elems, axis: int = -1):
    """Inclusive associative scan along `axis` via two power-of-2 levels.

    combine: pytree combine fn; identity: pytree of scalars used for
    padding; elems: pytree of equal-shape arrays.
    """
    leaves = jax.tree_util.tree_leaves(elems)
    n = leaves[0].shape[axis]
    if n <= BLOCK:
        return _hillis_steele_scan(combine, identity, elems, axis=axis)

    def to_last(x):
        return jnp.moveaxis(x, axis, -1)

    def pad_block(x, ident):
        pad_n = (-n) % BLOCK
        if pad_n == 0:
            return x
        pad_widths = [(0, 0)] * (x.ndim - 1) + [(0, pad_n)]
        return jnp.pad(x, pad_widths, constant_values=ident)

    moved = jax.tree_util.tree_map(to_last, elems)
    padded = jax.tree_util.tree_map(pad_block, moved, identity)
    nb = (n + BLOCK - 1) // BLOCK
    blocked = jax.tree_util.tree_map(
        lambda x: x.reshape(x.shape[:-1] + (nb, BLOCK)), padded)

    inner = _hillis_steele_scan(combine, identity, blocked, axis=-1)
    totals = jax.tree_util.tree_map(lambda x: x[..., -1], inner)
    tot_scan = _hillis_steele_scan(combine, identity, totals, axis=-1)
    # exclusive prefix per block: identity for block 0
    carry = jax.tree_util.tree_map(
        lambda x, ident: jnp.concatenate(
            [jnp.full(x.shape[:-1] + (1,), ident, x.dtype), x[..., :-1]],
            axis=-1),
        tot_scan, identity)
    carry_b = jax.tree_util.tree_map(lambda x: x[..., None], carry)
    out = combine(carry_b, inner)
    out = jax.tree_util.tree_map(
        lambda x: x.reshape(x.shape[:-2] + (nb * BLOCK,))[..., :n], out)
    return jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, -1, axis), out)


# The lane-parallel two-pass scan (below) folds time onto LANES contiguous
# segments and scans sequentially with wide vector rows - ~2n work vs the
# shift-combine form's ~n log(block), at the price of
# [.., LANES, seg] <-> [.., seg, LANES] transposes and scan loop overhead.
# It lost to the tiled form on the previous accelerator; on the card it is
# unmeasured, so it stays off behind USE_LANE_SCAN.
USE_LANE_SCAN = False
LANE_SCAN_MIN = 65536
LANES = 8192


def _lane_scan(combine, identity, leaves):
    """Inclusive scan of associative maps along the last axis via the
    lane-parallel two-pass method: fold time onto LANES contiguous
    segments, sequential-scan one [LANES]-wide row per step, then fix up
    lane boundaries with one tiny cross-lane scan.

    leaves: tuple of [..., n] arrays (the map components); identity: tuple
    of scalar identity components. Returns the scanned tuple.
    """
    n = leaves[0].shape[-1]
    lead = leaves[0].shape[:-1]
    seg = -(-n // LANES)
    pad = seg * LANES - n

    def prep(x, ident):
        if pad:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)],
                        constant_values=ident)
        x = x.reshape(lead + (LANES, seg)).swapaxes(-1, -2)
        return jnp.moveaxis(x, -2, 0)      # [seg, ..., LANES]

    rows = tuple(prep(x, i) for x, i in zip(leaves, identity))
    init = tuple(jnp.full(lead + (LANES,), i, leaves[0].dtype)
                 for i in identity)

    def body(carry, row):
        new = combine(carry, row)
        return new, new

    _, locs = jax.lax.scan(body, init, rows)
    locs = tuple(jnp.moveaxis(x, 0, -2) for x in locs)  # [..., seg, LANES]

    totals = tuple(x[..., -1, :] for x in locs)
    prefix = _hillis_steele_scan(combine, identity, totals, axis=-1)
    # exclusive shift across lanes
    prefix = tuple(
        jnp.concatenate([jnp.full_like(x[..., :1], i), x[..., :-1]],
                        axis=-1)
        for x, i in zip(prefix, identity))
    prefix_b = tuple(x[..., None, :] for x in prefix)
    out = combine(prefix_b, locs)
    return tuple(
        x.swapaxes(-1, -2).reshape(lead + (seg * LANES,))[..., :n]
        for x in out)


def linear_scanned_maps(a: jnp.ndarray, b: jnp.ndarray, axis: int = -1):
    """Composed prefix maps of y -> a*y + b along `axis`: returns (aa, bb)
    with y[n] = aa[n] * y[-1] + bb[n]. The building block of both the
    single-chip recurrence and the sequence-parallel boundary-state handoff
    (flan_tpu.parallel.scan_sp)."""
    a = jnp.broadcast_to(a, b.shape).astype(b.dtype)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    n = b.shape[axis]
    if USE_LANE_SCAN and n >= LANE_SCAN_MIN:
        aa, bb = _lane_scan(combine, (1.0, 0.0),
                            (jnp.moveaxis(a, axis, -1),
                             jnp.moveaxis(b, axis, -1)))
        return jnp.moveaxis(aa, -1, axis), jnp.moveaxis(bb, -1, axis)
    return _tiled_scan(combine, (1.0, 0.0), (a, b), axis=axis)


def linear_recurrence(a: jnp.ndarray, b: jnp.ndarray,
                      y0=0.0, axis: int = -1) -> jnp.ndarray:
    """Solve y[n] = a[n] * y[n-1] + b[n] with y[-1] = y0, in parallel.

    a, b broadcastable; scan along `axis`. Returns y with same shape as b.
    """
    aa, bb = linear_scanned_maps(a, b, axis=axis)
    return aa * jnp.asarray(y0, b.dtype) + bb


def max_affine_recurrence(m: jnp.ndarray, a: jnp.ndarray, c: jnp.ndarray,
                          y0=0.0, axis: int = -1) -> jnp.ndarray:
    """Solve y[n] = max(m[n], a[n] * y[n-1] + c[n]) in parallel.

    Composition law: (m2,a2,c2) o (m1,a1,c1) =
    (max(m2, a2*m1 + c2), a2*a1, a2*c1 + c2). Used by the compressor's
    smooth decoupled peak detector (reference AudioVolume.cpp:246-253).
    Requires a >= 0 (true for exp(-1/t*sr) smoothing coefficients).
    """
    shape = jnp.broadcast_shapes(m.shape, a.shape, c.shape)
    m = jnp.broadcast_to(m, shape)
    a = jnp.broadcast_to(a, shape).astype(m.dtype)
    c = jnp.broadcast_to(c, shape).astype(m.dtype)

    def combine(l, r):
        ml, al, cl = l
        mr, ar, cr = r
        return (jnp.maximum(mr, ar * ml + cr), al * ar, ar * cl + cr)

    # identity m must be finite: decay products underflow to exactly 0 and
    # 0 * -inf = NaN. A large negative finite value represents the same
    # map (max(m', 0*y + c') == max(m', c') either way).
    if USE_LANE_SCAN and m.shape[axis] >= LANE_SCAN_MIN:
        mm, aa, cc = _lane_scan(
            combine, (-1e30, 1.0, 0.0),
            tuple(jnp.moveaxis(x, axis, -1) for x in (m, a, c)))
        mm, aa, cc = (jnp.moveaxis(x, -1, axis) for x in (mm, aa, cc))
    else:
        mm, aa, cc = _tiled_scan(combine, (-1e30, 1.0, 0.0), (m, a, c),
                                 axis=axis)
    y0_arr = jnp.asarray(y0, m.dtype)
    return jnp.maximum(mm, aa * y0_arr + cc)


def matrix_affine_scanned_leaves(A: jnp.ndarray, b: jnp.ndarray):
    """Composed prefix-map leaves of y -> A @ y + b along the T axis.

    A: [..., T, k, k], b: [..., T, k]. Returns a tuple of k*k + k leaves,
    each [..., T]: leaf i*k+j is AA[t][i, j] and leaf k*k+i is bb[t][i],
    such that y[t] = AA[t] @ y[-1] + bb[t].

    Each matrix/vector component is its own scan leaf with the time axis
    last (contiguous): scanning [..., T, 2, 2] directly would leave T
    strided behind the tiny matrix dims.
    The component identity scalars let the tiled two-level scan pad blocks.
    """
    k = A.shape[-1]
    perm_a = (A.ndim - 2, A.ndim - 1) + tuple(range(A.ndim - 2))
    At = jnp.transpose(A, perm_a)                     # [k, k, ..., T]
    bt = jnp.transpose(b, (b.ndim - 1,) + tuple(range(b.ndim - 1)))
    a_leaves = tuple(At[i, j] for i in range(k) for j in range(k))
    b_leaves = tuple(bt[i] for i in range(k))
    identity = tuple(1.0 if i == j else 0.0
                     for i in range(k) for j in range(k)) \
        + (0.0,) * k

    def combine(l, r):
        # (Ar @ Al)[i, j] = sum_m Ar[i, m] * Al[m, j], elementwise over T
        al = l[: k * k]
        bl = l[k * k:]
        ar = r[: k * k]
        br = r[k * k:]
        aa = tuple(
            sum(ar[i * k + m] * al[m * k + j] for m in range(k))
            for i in range(k) for j in range(k))
        bb = tuple(
            sum(ar[i * k + m] * bl[m] for m in range(k)) + br[i]
            for i in range(k))
        return aa + bb

    if USE_LANE_SCAN and a_leaves[0].shape[-1] >= LANE_SCAN_MIN:
        return _lane_scan(combine, identity, a_leaves + b_leaves)
    return _tiled_scan(combine, identity, a_leaves + b_leaves, axis=-1)


def matrix_affine_recurrence(A: jnp.ndarray, b: jnp.ndarray,
                             y0: jnp.ndarray) -> jnp.ndarray:
    """Solve y[n] = A[n] @ y[n-1] + b[n] for small state dims, in parallel.

    A: [..., T, k, k], b: [..., T, k], y0: [..., k]. Scans along the T
    axis; k is 2 for the reference's 2-pole SVF state (s1, s2).
    """
    k = A.shape[-1]
    out = matrix_affine_scanned_leaves(A, b)
    AA = out[: k * k]
    bb = out[k * k:]
    # y[t] = AA[t] @ y0 + bb[t], components over leading dims
    y = jnp.stack([
        sum(AA[i * k + m] * y0[..., m, None] for m in range(k)) + bb[i]
        for i in range(k)], axis=0)                   # [k, ..., T]
    return jnp.moveaxis(y, 0, -1)                      # [..., T, k]
