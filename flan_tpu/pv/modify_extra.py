"""PV desample / smear / extrapolate / spline-stretch / general modify.

JAX re-design of the remaining reference resampling family
(reference: src/flan/PV/PVModify.cpp:15-194, 387-666). Bound onto PV in
flan_tpu.pv.__init__.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from flan_tpu.func import interpolators
from flan_tpu.func.function import as_function, as_function2d


def desample(self, decimation_ratio,
             interp: Callable = interpolators.linear):
    """Integrate-and-select decimation with interpolated restoration
    (reference PVModify.cpp:445-511). The per-bin accumulator loop becomes
    cumsum + integer-crossing masks; bracketing selected frames come from
    forward/backward cumulative max/min - no sequential walk."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    c, f, b = self.mag.shape
    ratio = jnp.clip(jnp.broadcast_to(
        self._sample_2d(decimation_ratio), (f, b)), 0.0, 1.0)

    # accumulator starts at 1 so frame 0 is always selected
    acc = 1.0 + jnp.cumsum(ratio, axis=0)
    crossings = jnp.floor(acc)
    prev = jnp.concatenate([jnp.zeros((1, b)), crossings[:-1]], axis=0)
    selected = (crossings - prev) >= 1.0                  # [F, B]

    f_idx = jnp.arange(f, dtype=jnp.float32)[:, None]
    # lFrame: most recent selected frame <= f (inclusive)
    l_frame = jax.lax.associative_scan(
        jnp.maximum, jnp.where(selected, f_idx, -1.0), axis=0)
    # rFrame: next selected frame > f (exclusive)
    r_rev = jax.lax.associative_scan(
        jnp.minimum, jnp.where(selected, f_idx, jnp.float32(f + 1))[::-1],
        axis=0)[::-1]
    r_frame = jnp.concatenate([r_rev[1:], jnp.full((1, b), f + 1.0)],
                              axis=0)
    valid = (l_frame >= 0) & (r_frame <= f - 1)

    li = jnp.clip(l_frame, 0, f - 1).astype(jnp.int32)
    ri = jnp.clip(r_frame, 0, f - 1).astype(jnp.int32)
    mix = interp(jnp.clip(
        (f_idx - l_frame) / jnp.maximum(r_frame - l_frame, 1e-9), 0.0, 1.0))

    def gather(a, idx):
        return jnp.take_along_axis(a, idx[None].repeat(c, 0), axis=1)

    lm = gather(self.mag, li)
    rm = gather(self.mag, ri)
    lf = gather(self.freq, li)
    rf = gather(self.freq, ri)
    w0 = (1.0 - mix)[None] * lm
    w1 = mix[None] * rm
    out_mag = jnp.where(valid[None], w0 + w1, 0.0)
    out_freq = jnp.where(valid[None], jnp.where(w0 > w1, lf, rf), 0.0)
    return self._with(mag=out_mag, freq=out_freq)


def smear_time(self, smear_size, granularity=5, distribution=None,
               max_kernel: Optional[int] = None):
    """Windowed time average of surrounding MF data
    (reference PVModify.cpp:513-605). The kernel half-width is derived
    from the sampled smear sizes themselves (no static truncation; the
    reference walks arbitrary distances) and the offset sweep runs as one
    lax.scan, so huge smears neither clip nor explode the trace.
    max_kernel remains as an optional explicit ceiling."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    if distribution is None:
        distribution = lambda t: 0.5 * (1.0 + jnp.cos(jnp.pi * t))
    c, f, b = self.mag.shape

    smear = jnp.maximum(jnp.broadcast_to(
        self._sample_2d(smear_size), (f, b)), 0.0)       # seconds
    # granularity is an INT-valued Function upstream
    # (Function<TF, int>, PVModify.cpp:515): truncate, then max(i, 1)
    gran = jnp.maximum(jnp.trunc(jnp.broadcast_to(
        self._sample_2d(granularity), (f, b))), 1.0).astype(jnp.int32)

    exp_frames = smear * self.analysis_rate               # [F, B] float
    # loop bounds and extents use the TRUNCATED frame count (the Frame
    # cast of time_to_frame, PVModify.cpp:545,573); the distribution
    # weights below keep the float smear (golden-tested)
    exp_int = jnp.trunc(exp_frames)
    max_exp = int(jnp.max(exp_int))
    # output extents scan EVERY frame (PVModify.cpp:537-552):
    # leftmost = min(0, min_f(f - exp)), rightmost = max(F-1, max_f(f + exp))
    fr_ix = jnp.arange(f, dtype=jnp.float32)[:, None]
    leftmost = int(jnp.minimum(0.0, jnp.min(fr_ix - exp_int)))
    rightmost = int(jnp.maximum(float(f - 1), jnp.max(fr_ix + exp_int)))
    left = -leftmost
    f_out = rightmost - leftmost

    half_taps = max(max_exp, 1)                           # from the data
    if max_kernel is not None and half_taps > max_kernel:
        import warnings
        warnings.warn(f"smear_time: derived kernel {half_taps} half-taps "
                      f"clipped to explicit max_kernel={max_kernel}")
        half_taps = max_kernel
    elif max_kernel is None and half_taps > 4096:
        import warnings
        warnings.warn(
            f"smear_time: smear sizes imply a {half_taps}-half-tap kernel "
            "(each tap is a full-plane pass); pass max_kernel to bound it")
    offs = jnp.arange(-half_taps, half_taps, dtype=jnp.int32)

    # The distribution is pre-sampled on a quantized 1/(2*max_exp) grid
    # and looked up by the truncated index size*0.5*(1+d)
    # (PVModify.cpp:554-556, 581-584) — direct evaluation diverges on
    # any non-linear distribution between grid points
    m2 = 2 * max(max_exp, 1)
    dist_table = jnp.asarray(distribution(
        jnp.arange(-m2, m2, dtype=jnp.float32) / jnp.float32(m2)),
        jnp.float32)
    tbl_size_f = jnp.float32(2 * m2)

    in_frame = jnp.clip(jnp.arange(f_out) - left, 0, f - 1)
    smear_o = smear[in_frame]                             # [F_out, B] s
    exp_o_int = exp_int[in_frame].astype(jnp.int32)
    gran_o = gran[in_frame]                               # [F_out, B] int
    out_rows = jnp.arange(f_out)

    # frames padded so every offset is one dynamic_slice of length f_out:
    # src row i-left+off maps to padded row i + off + half_taps
    pad_l = left + half_taps
    pad_r = max(0, f_out - left + half_taps - f)
    mag_p = jnp.pad(self.mag, [(0, 0), (pad_l, pad_r), (0, 0)])
    freq_p = jnp.pad(self.freq, [(0, 0), (pad_l, pad_r), (0, 0)])

    def body(carry, off):
        mag_sum, freq_sum, total_w, used_w = carry
        # reference loop: for off = -exp; off < exp; off += gran
        # (PVModify.cpp:578) — anchored at -exp, stepping the
        # per-(frame,bin) integer granularity
        in_window = ((off >= -exp_o_int) & (off < exp_o_int)
                     & ((off + exp_o_int) % gran_o == 0))
        # quantized-table weight: d = frame_to_time(off)/smear (f32),
        # idx = trunc(size * 0.5 * (1 + d)), clamped
        d = (off.astype(jnp.float32) / jnp.float32(self.analysis_rate)
             ) / jnp.maximum(smear_o, 1e-30)
        idx = jnp.clip((tbl_size_f * jnp.float32(0.5)
                        * (1.0 + d)).astype(jnp.int32), 0, 2 * m2 - 1)
        w = dist_table[idx] * in_window
        src = out_rows - left + off
        ok = (src >= 0) & (src < f)
        w_ok = w * ok[:, None]
        mslice = jax.lax.dynamic_slice(
            mag_p, (0, off + half_taps, 0), (c, f_out, b))
        fslice = jax.lax.dynamic_slice(
            freq_p, (0, off + half_taps, 0), (c, f_out, b))
        return (mag_sum + mslice * w_ok[None],
                freq_sum + fslice * w_ok[None],
                total_w + w, used_w + w_ok), None

    init = (jnp.zeros((c, f_out, b), jnp.float32),
            jnp.zeros((c, f_out, b), jnp.float32),
            jnp.zeros((f_out, b), jnp.float32),
            jnp.zeros((f_out, b), jnp.float32))
    (mag_sum, freq_sum, total_w, used_w), _ = jax.lax.scan(
        body, init, offs)

    out_mag = jnp.where(total_w[None] > 0, mag_sum / jnp.maximum(
        total_w[None], 1e-12), 0.0)
    out_freq = jnp.where(used_w[None] > 0, freq_sum / jnp.maximum(
        used_w[None], 1e-12), 0.0)
    return self._with(mag=out_mag, freq=out_freq)


def time_extrapolate(self, start_time: float, end_time: float,
                     extrap_time: float,
                     interp: Callable = interpolators.linear):
    """Interpolate between two anchor frames, then keep extrapolating,
    with bin-shift alignment (reference PVModify.cpp:607-666)."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    length = self.length
    start_time = float(np.clip(start_time, 0.0, length))
    if end_time == -1:
        end_time = length
    end_time = float(np.clip(end_time, 0.0, length))
    if start_time >= end_time or extrap_time <= 0:
        return PV.create_null()

    c, f, b = self.mag.shape
    start = int(self.time_to_frame(start_time))
    end = int(self.time_to_frame(end_time))
    ext = int(self.time_to_frame(extrap_time))
    f_out = end + ext

    # Reference quirk (golden-tested): the interpolator table is filled
    # with interp((i - start_frame)/(end - start)) for i = 0..size-1 but
    # indexed by (frame - start_frame) (PVModify.cpp:628-631, 640), so
    # the ramp the output actually sees is shifted a further start_frame
    # left: output frame k mixes interp((k - 2*start)/(end - start)) —
    # negative inputs reach the (unclamped) interpolator.
    mix = interp(jnp.asarray(
        (np.arange(start, f_out) - 2 * start) / max(end - start, 1),
        jnp.float32))                                     # [F_out-start]

    lm = self.mag[:, start][:, None, :]
    rm = self.mag[:, end][:, None, :]
    lf = self.freq[:, start][:, None, :]
    rf = self.freq[:, end][:, None, :]
    m = mix[None, :, None]
    ext_mag = jnp.abs((1 - m) * lm + m * rm)
    ext_freq = (1 - m) * lf + m * rf

    bin_ix = jnp.arange(b)[None, None, :]
    # C truncation lands on the FLOAT expressions, nested (same rule as
    # PV::shape, golden-tested): shift = Bin(bin - f2b(right.f)), then
    # target = Bin(f2b(extrap.f) + shift)
    right_shift = jnp.trunc(bin_ix.astype(jnp.float32)
                            - rf / self.bin_width)
    target = jnp.trunc(ext_freq / self.bin_width
                       + right_shift).astype(jnp.int32)
    valid = (target >= 0) & (target < b)
    tb = jnp.clip(target, 0, b - 1)
    n_ext = f_out - start
    chan_ix = jnp.arange(c)[:, None, None]
    frame_ix = jnp.arange(n_ext)[None, :, None]
    sc_mag = jnp.zeros((c, n_ext, b), jnp.float32).at[
        chan_ix, frame_ix, tb].max(jnp.where(valid, ext_mag, -1.0))
    winner = sc_mag[chan_ix, frame_ix, tb]
    # first-wins on equal-magnitude ties, as in PV::shape: the
    # sequential strict-> write keeps the LOWEST source bin's frequency
    # (PVModify.cpp:661-662)
    ext_mag_b = jnp.broadcast_to(ext_mag, (c, n_ext, b))
    tie = valid & (ext_mag_b == winner) & (ext_mag_b > 0)
    src_bin = jnp.broadcast_to(bin_ix, (c, n_ext, b)).astype(jnp.int32)
    win_src = jnp.full((c, n_ext, b), b, jnp.int32).at[
        chan_ix, frame_ix, tb].min(jnp.where(tie, src_bin, b))
    ext_freq_b = jnp.broadcast_to(ext_freq, (c, n_ext, b))
    got = jnp.take_along_axis(ext_freq_b, jnp.clip(win_src, 0, b - 1),
                              axis=-1)
    sc_freq = jnp.where(win_src < b, got, 0.0)

    out_mag = jnp.concatenate(
        [self.mag[:, :start], jnp.maximum(sc_mag, 0.0)], axis=1)
    out_freq = jnp.concatenate([self.freq[:, :start], sc_freq], axis=1)
    return self._with(mag=out_mag, freq=out_freq)


def stretch_spline(self, expansion):
    """Integer per-frame expansion filled by natural cubic splines
    (reference PVModify.cpp:387-443). The tk::spline-per-bin loop becomes
    one shared spline-evaluation matrix (knot positions are bin-independent)
    applied to all channels/bins as a single matmul."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    c, f, b = self.mag.shape
    fn = as_function(expansion)
    t = np.arange(f, dtype=np.float64) / self.analysis_rate
    if fn.is_constant:
        exp = np.full(f, fn.constant_value)
    else:
        exp = np.asarray(fn(jnp.asarray(t, jnp.float32)),
                         np.float64).reshape(-1)
        exp = np.broadcast_to(exp, (f,))
    exp = np.maximum(exp.astype(np.int64), 1)

    xs = np.zeros(f, np.float64)
    total = 0
    for i in range(f - 1):
        xs[i] = total
        total += int(exp[i])
    xs[f - 1] = total
    f_out = int(total)
    if f_out <= 0:
        return PV.create_null()

    W = _natural_spline_matrix(xs, np.arange(f_out, dtype=np.float64))
    Wj = jnp.asarray(W, jnp.float32)                       # [F_out, F]
    # HIGHEST: the reduced-precision default is TF32 on GPUs
    out_mag = jnp.einsum("tf,cfb->ctb", Wj, self.mag,
                         precision=jax.lax.Precision.HIGHEST)
    out_freq = jnp.einsum("tf,cfb->ctb", Wj, self.freq,
                          precision=jax.lax.Precision.HIGHEST)
    return self._with(mag=out_mag, freq=out_freq)


def _natural_spline_matrix(xs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """W with out = W @ y giving the natural cubic spline through
    (xs, y) evaluated at ts. Dense [T, F]; spline interpolation is linear
    in y so one matrix serves every bin and channel."""
    n = len(xs)
    h = np.diff(xs)
    # second-derivative system A m = B y (natural boundary: m0 = mn = 0)
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    A[0, 0] = 1.0
    A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1] / 6.0
        A[i, i] = (h[i - 1] + h[i]) / 3.0
        A[i, i + 1] = h[i] / 6.0
        B[i, i - 1] = 1.0 / h[i - 1]
        B[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        B[i, i + 1] = 1.0 / h[i]
    Minv = np.linalg.solve(A, B)          # m = Minv @ y

    idx = np.clip(np.searchsorted(xs, ts, side="right") - 1, 0, n - 2)
    x0 = xs[idx]
    x1 = xs[idx + 1]
    hi = x1 - x0
    u = (ts - x0) / hi
    # s(t) = (1-u) y0 + u y1 + h^2/6 [ ((1-u)^3-(1-u)) m0 + (u^3-u) m1 ]
    W = np.zeros((len(ts), n))
    rows = np.arange(len(ts))
    W[rows, idx] += (1 - u)
    W[rows, idx + 1] += u
    c0 = hi * hi / 6.0 * ((1 - u) ** 3 - (1 - u))
    c1 = hi * hi / 6.0 * (u ** 3 - u)
    M0 = Minv[idx]        # [T, F]
    M1 = Minv[idx + 1]
    W += c0[:, None] * M0 + c1[:, None] * M1
    return W


def modify(self, mod, interp: Callable = interpolators.linear,
           max_quad_span: Optional[int] = None):
    """General time x frequency remap via quad rasterization
    (reference PVModify.cpp:15-194). Each input cell quad is rasterized
    with inverse-bilinear interpolation and MIMM scatter-max writes over a
    neighborhood whose span is derived from the mapped quads themselves
    (the reference rasterizes arbitrarily large quads with per-frame
    mutexes; here a lax.scan sweeps the derived span). max_quad_span is an
    optional explicit ceiling."""
    from flan_tpu.pv.pv import PV
    if self.is_null():
        return PV.create_null()
    c, f, b = self.mag.shape
    fn = as_function2d(mod) if not callable(mod) else mod

    # f32 multiply grid exactly as the reference samples it
    # (Function.h:165-167 x*x_scale); see pv.py modify_time for why
    t = jnp.arange(f, dtype=jnp.float32) * jnp.float32(1.0
                                                       / self.analysis_rate)
    fr = jnp.arange(b, dtype=jnp.float32) * self.bin_width
    mapped = fn(t[:, None], fr[None, :])
    if isinstance(mapped, tuple):
        m_t, m_f = mapped
    else:
        mapped = jnp.asarray(mapped)
        m_t, m_f = mapped[..., 0], mapped[..., 1]
    # to output frame/bin coordinates
    PX = jnp.broadcast_to(m_t, (f, b)) * self.analysis_rate
    PY = jnp.broadcast_to(m_f, (f, b)) / self.bin_width

    out_frames = int(np.ceil(float(jnp.max(PX))))
    if out_frames / self.analysis_rate > 600.0:
        # the reference refuses >10 minute outputs (PVModify.cpp:31-35)
        return PV.create_null()
    out_frames = max(out_frames, 1)

    # per-MF modified frequency: mod applied at the MF's own frequency
    tt = jnp.broadcast_to(t[None, :, None], self.freq.shape)
    mf_mapped = fn(tt, self.freq)
    if isinstance(mf_mapped, tuple):
        mf_freq = jnp.broadcast_to(mf_mapped[1], self.freq.shape)
    else:
        mf_freq = jnp.broadcast_to(jnp.asarray(mf_mapped)[..., 1],
                                   self.freq.shape)

    # quad corners for cell (frame, bin): p00=(f-1,b-1) p10=(f,b-1)
    # p11=(f,b) p01=(f-1,b)
    x00, y00 = PX[:-1, :-1], PY[:-1, :-1]
    x10, y10 = PX[1:, :-1], PY[1:, :-1]
    x11, y11 = PX[1:, 1:], PY[1:, 1:]
    x01, y01 = PX[:-1, 1:], PY[:-1, 1:]

    # inverse bilinear coefficients (PVModify.cpp:109-137)
    a0, a1 = x00, x10 - x00
    a2, a3 = x01 - x00, x00 - x10 + x11 - x01
    b0, b1 = y00, y10 - y00
    b2, b3 = y01 - y00, y00 - y10 + y11 - y01

    minx = jnp.floor(jnp.minimum(jnp.minimum(x00, x10),
                                 jnp.minimum(x11, x01))).astype(jnp.int32)
    miny = jnp.floor(jnp.minimum(jnp.minimum(y00, y10),
                                 jnp.minimum(y11, y01))).astype(jnp.int32)

    mags = (self.mag[:, :-1, :-1], self.mag[:, 1:, :-1],
            self.mag[:, 1:, 1:], self.mag[:, :-1, 1:])
    freqs = (mf_freq[:, :-1, :-1], mf_freq[:, 1:, :-1],
             mf_freq[:, 1:, 1:], mf_freq[:, :-1, 1:])

    # derive the rasterization span from the mapped quads themselves
    #: the neighborhood swept per quad covers
    # the largest quad bounding box in the data, so nothing clips.
    maxx = jnp.maximum(jnp.maximum(x00, x10), jnp.maximum(x11, x01))
    maxy = jnp.maximum(jnp.maximum(y00, y10), jnp.maximum(y11, y01))
    span_x = int(float(jnp.max(jnp.floor(maxx) - minx))) + 1
    span_y = int(float(jnp.max(jnp.floor(maxy) - miny))) + 1
    span_x = max(span_x, 1)
    span_y = max(span_y, 1)
    if max_quad_span is not None and (span_x > max_quad_span
                                      or span_y > max_quad_span):
        import warnings
        warnings.warn(
            f"PV.modify: derived quad span ({span_x}x{span_y}) clipped "
            f"to explicit max_quad_span={max_quad_span}; extreme quads "
            "will rasterize incompletely")
        span_x = min(span_x, max_quad_span)
        span_y = min(span_y, max_quad_span)
    elif max_quad_span is None and span_x * span_y > 4096:
        import warnings
        warnings.warn(
            f"PV.modify: one quad spans {span_x}x{span_y} output cells, "
            f"driving a {span_x * span_y}-step rasterization scan; pass "
            "max_quad_span to trade completeness for speed")

    chan_ix = jnp.arange(c)[:, None, None]
    freqs_st = jnp.stack(freqs)

    def step_vals(step):
        """(tx, ty, val, sel_freq, ok) for neighborhood offset index."""
        dx = step // span_y
        dy = step % span_y
        X = (minx + dx).astype(jnp.float32)
        Y = (miny + dy).astype(jnp.float32)
        # solve bilinear (l, m): X = a0+a1 l+a2 m+a3 l m, same for Y
        qa = a3 * b2 - a2 * b3
        qb = (a3 * b0 - a0 * b3 + a1 * b2 - a2 * b1
              + X * b3 - a3 * Y)
        qc = a1 * b0 - a0 * b1 + X * b1 - a1 * Y
        disc = qb * qb - 4.0 * qa * qc
        lin = jnp.abs(qa) < 1e-9
        mm = jnp.where(
            lin,
            -qc / jnp.where(jnp.abs(qb) > 1e-9, qb, 1.0),
            (-qb + jnp.sqrt(jnp.maximum(disc, 0.0)))
            / jnp.where(lin, 1.0, 2.0 * qa))
        ldenom = a1 + a3 * mm
        ll = (X - a0 - a2 * mm) / jnp.where(jnp.abs(ldenom) > 1e-9,
                                            ldenom, 1.0)
        eps = 1e-4
        # Crossing-number inside test, half-open in y exactly as the
        # reference (PVModify.cpp:100-105): a pixel on a quad's max-y
        # edge is OUTSIDE (golden-tested: output bins landing exactly on
        # a mapped edge stay empty). Edge k runs p[k-1]->p[k] with the
        # intercept anchored at the reference's anchor corner.
        def _edge(py, qy, ax, ay, dxx, dyy):
            yr = ((py <= Y) & (Y < qy)) | ((qy <= Y) & (Y < py))
            icpt = dxx / jnp.where(dyy == 0.0, 1.0, dyy) * (Y - ay) + ax
            return yr & (X < icpt)
        cross = (_edge(y00, y01, x00, y00, x00 - x01, y00 - y01)
                 ^ _edge(y10, y00, x10, y10, x10 - x00, y10 - y00)
                 ^ _edge(y11, y10, x11, y11, x11 - x10, y11 - y10)
                 ^ _edge(y01, y11, x01, y01, x01 - x11, y01 - y11))
        inside = (cross
                  & (jnp.abs(ll - 0.5) <= 0.5 + eps)
                  & (jnp.abs(mm - 0.5) <= 0.5 + eps)
                  & (disc >= 0))
        iL = interp(jnp.clip(ll, 0.0, 1.0))
        iM = interp(jnp.clip(mm, 0.0, 1.0))
        w = jnp.stack([
            (1 - iL) * (1 - iM) * mags[0],
            iL * (1 - iM) * mags[1],
            iL * iM * mags[2],
            (1 - iL) * iM * mags[3],
        ])
        max_i = jnp.argmax(w, axis=0)
        max_w = jnp.max(w, axis=0)
        sel_freq = jnp.take_along_axis(freqs_st, max_i[None], axis=0)[0]
        tx = jnp.clip(minx + dx, 0, out_frames - 1)
        ty = jnp.clip(miny + dy, 0, b - 1)
        ok = (inside[None] & (minx + dx >= 0)[None]
              & (minx + dx < out_frames)[None]
              & (miny + dy >= 0)[None] & (miny + dy < b)[None]
              & (max_w > 0))
        val = jnp.where(ok, max_w, -1.0)
        return tx, ty, val, sel_freq, ok

    steps = jnp.arange(span_x * span_y, dtype=jnp.int32)

    # pass 1: MIMM magnitude scatter-max over the derived neighborhood
    def mag_body(out_m, step):
        tx, ty, val, _, _ = step_vals(step)
        return out_m.at[chan_ix, tx[None], ty[None]].max(val), None

    out_mag, _ = jax.lax.scan(
        mag_body, jnp.zeros((c, out_frames, b), jnp.float32), steps)

    # pass 2: the winning magnitude's frequency (recomputed per step so no
    # O(span^2 x F x B) write list is materialized)
    def freq_body(out_f, step):
        tx, ty, val, sel_freq, ok = step_vals(step)
        winner = out_mag[chan_ix, tx[None], ty[None]]
        write = ok & (val >= winner) & (val > 0)
        return out_f.at[chan_ix, tx[None], ty[None]].max(
            jnp.where(write, sel_freq, -jnp.inf)), None

    out_freq, _ = jax.lax.scan(
        freq_body, jnp.full((c, out_frames, b), -jnp.inf), steps)
    out_freq = jnp.where(jnp.isneginf(out_freq), 0.0, out_freq)
    return self._with(mag=out_mag, freq=out_freq)
