"""Graph: multi-plane plotting for waveforms, spectrograms, functions.

JAX re-design of the reference Graph
(reference: src/flan/Graph.h:21-283, Graph.cpp). The reference subclasses a
BMP image and paints per-pixel in parallel-STL loops; here rendering is
vectorized numpy over a [H, W, 3] float image (spectrogram/waveform tensors
are computed on device, rendering happens at the host boundary like all
image I/O - SURVEY.md native-component checklist).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from flan_tpu.utils.geometry import Color, Interval, Rect, View, hsv_to_rgb

ALL_PLANES = -1


def _vectorized1(f):
    """Evaluate a scalar callable on float32 arrays, falling back to a
    per-element loop when it rejects array input."""
    def samp(u):
        try:
            out = np.asarray(f(u), np.float32)
            if out.shape != np.shape(u):
                raise ValueError
            return out
        except Exception:
            return np.asarray([float(f(float(x))) for x in np.ravel(u)],
                              np.float32).reshape(np.shape(u))
    return samp


def _vectorized2(f):
    """Evaluate an (x, y) callable on broadcastable float32 grids,
    falling back to a per-element loop."""
    def samp(u, yu):
        ub, yb = np.broadcast_arrays(u, yu)
        try:
            out = np.asarray(f(ub, yb), np.float32)
            if out.shape != ub.shape:
                raise ValueError
            return out
        except Exception:
            return np.asarray(
                [float(f(float(a), float(b)))
                 for a, b in zip(ub.ravel(), yb.ravel())],
                np.float32).reshape(ub.shape)
    return samp


class WaveformMode:
    DIRECT = "direct"
    SYMMETRIC = "symmetric"


class Graph:
    DEFAULT_WIDTH = 1024
    DEFAULT_HEIGHT = 512

    def __init__(self, width: int = -1, height: int = -1):
        self.width = width if width > 0 else Graph.DEFAULT_WIDTH
        self.height = height if height > 0 else Graph.DEFAULT_HEIGHT
        self.image = np.zeros((self.height, self.width, 3), np.float32)
        self.views: List[Tuple[int, View]] = []

    # --- Views (reference Graph.h:55-85) ------------------------------------
    def add_view(self, view: View, plane: int = ALL_PLANES) -> None:
        self.views.append((plane, view))

    def set_view(self, rect: Rect) -> None:
        self.views = [(ALL_PLANES,
                       View(rect, Rect(0, 0, self.width, self.height)))]

    def add_split_view_y(self, view: View, num_views: int,
                         start_plane: int = 0) -> None:
        """Reference Graph.cpp:31-41 stacks the split V rects in
        BOTTOM-UP pixel space (set_pixel flips): plane 0 gets the
        BOTTOM strip. Our V rects are top-down, so count from y2."""
        for i in range(num_views):
            h = view.V.h / num_views
            v = Rect(view.V.x1, view.V.y2 - (i + 1) * h,
                     view.V.x2, view.V.y2 - i * h)
            self.views.append((start_plane + i, View(view.U, v)))

    def add_full_split_view_y(self, rect: Rect, num_views: int,
                              start_plane: int = 0) -> None:
        self.add_split_view_y(
            View(rect, Rect(0, 0, self.width, self.height)), num_views,
            start_plane)

    def do_planes_match(self, p1: int, p2: int) -> bool:
        """Reference Graph.h:82 — ALL_PLANES matches everything."""
        return p1 == ALL_PLANES or p2 == ALL_PLANES or p1 == p2

    def _active_views(self, rect: Rect, plane: int):
        out = []
        for p, v in self.views:
            if not self.do_planes_match(plane, p):
                continue
            if rect.intersect(v.U).valid():
                out.append((p, v))
        return out

    def get_intersecting_views(self, rect: Rect, plane: int = ALL_PLANES):
        """Public (plane, View) pairs whose U-space intersects rect
        (reference Graph.h get_intersecting_views)."""
        return self._active_views(rect, plane)

    # --- Basics -------------------------------------------------------------
    def fill_image(self, color: Color) -> None:
        self.image[:] = color.as_array()

    def set_pixel(self, x: int, y: int, color: Color) -> None:
        if 0 <= x < self.width and 0 <= y < self.height:
            self.image[y, x] = color.as_array()

    # --- bitmap_image-exact rasterizer core (bmp/bitmap_image.hpp,
    # pixel-golden vs the compiled reference: graph_*.bmp fixtures).
    # Conventions that matter: float coordinates TRUNCATE to int at the
    # image_drawer call boundary; horizontal/vertical segments are
    # END-EXCLUSIVE; line_segment is the exact Bresenham variant below
    # (which DOES plot its final endpoint); every pixel write clips.
    def _plot_px(self, x: int, y: int, arr) -> None:
        if 0 <= x < self.width and 0 <= y < self.height:
            self.image[y, x] = arr

    def _hseg_px(self, x1: float, x2: float, y: float, arr) -> None:
        """image_drawer::horiztonal_line_segment: [min, max), clipped."""
        a, b, py = int(x1), int(x2), int(y)
        if a > b:
            a, b = b, a
        if 0 <= py < self.height and b > a:
            self.image[py, max(a, 0):max(min(b, self.width), 0)] = arr

    def _vseg_px(self, y1: float, y2: float, x: float, arr) -> None:
        """image_drawer::vertical_line_segment: [min, max), clipped."""
        a, b, px = int(y1), int(y2), int(x)
        if a > b:
            a, b = b, a
        if 0 <= px < self.width and b > a:
            self.image[max(a, 0):max(min(b, self.height), 0), px] = arr

    def _bres_px(self, x1: float, y1: float, x2: float, y2: float,
                 arr) -> None:
        """image_drawer::line_segment's exact Bresenham
        (bitmap_image.hpp:2166-2203), incl. its multi-step error loop
        and the unconditional final endpoint plot."""
        x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
        fx, fy = x2, y2
        sx = 1 if (x2 - x1) > 0 else -1
        sy = 1 if (y2 - y1) > 0 else -1
        dx, dy = abs(x2 - x1), abs(y2 - y1)
        steep = dy > dx
        if steep:
            x1, y1 = y1, x1
            dx, dy = dy, dx
            sx, sy = sy, sx
        e = 2 * dy - dx
        for _ in range(dx):
            if steep:
                self._plot_px(y1, x1, arr)
            else:
                self._plot_px(x1, y1, arr)
            while e >= 0:
                y1 += sy
                e -= 2 * dx
            x1 += sx
            e += 2 * dy
        self._plot_px(fx, fy, arr)

    def _row_trunc(self, view: View, y: float) -> int:
        """Reference row of a plane y whose Pixel cast happens in
        BOTTOM-UP pixel space: height-1 - (Pixel)yUToV(y)
        (Graph.cpp:287-290, 545-546)."""
        yuv_bu = ((y - view.U.y1) / view.U.h * view.V.h
                  + (self.height - view.V.y2))
        return self.height - 1 - int(yuv_bu)

    # --- Primitives (reference Graph.h:206-222, Graph.cpp:287-345) ----------
    def set_point(self, view: View, x: float, y: float, color: Color) -> None:
        self.set_pixel(int(view.x_u_to_v(x)), self._row_trunc(view, y),
                       color)

    def draw_horizontal_line(self, view: View, x1: float, x2: float,
                             y: float, color: Color) -> None:
        """Graph.cpp:297-300: trunc floats, end-exclusive span."""
        self._hseg_px(view.x_u_to_v(x1), view.x_u_to_v(x2),
                      view.y_u_to_v(y), color.as_array())

    def draw_vertical_line(self, view: View, y1: float, y2: float,
                           x: float, color: Color) -> None:
        """Graph.cpp:302-305: trunc floats, end-exclusive span."""
        self._vseg_px(view.y_u_to_v(y2), view.y_u_to_v(y1),
                      view.x_u_to_v(x), color.as_array())

    def draw_line_segment(self, view: View, x1: float, y1: float,
                          x2: float, y2: float, color: Color) -> None:
        """Graph.cpp:307-310 via the exact Bresenham core."""
        self._bres_px(view.x_u_to_v(x1), view.y_u_to_v(y1),
                      view.x_u_to_v(x2), view.y_u_to_v(y2),
                      color.as_array())

    def set_rect(self, view: View, rect: Rect, color: Color) -> None:
        xa = int(round(view.x_u_to_v(rect.x1)))
        xb = int(round(view.x_u_to_v(rect.x2)))
        ya = int(round(view.y_u_to_v(rect.y1)))
        yb = int(round(view.y_u_to_v(rect.y2)))
        x_lo, x_hi = max(min(xa, xb), 0), min(max(xa, xb), self.width)
        y_lo, y_hi = max(min(ya, yb), 0), min(max(ya, yb), self.height)
        if x_hi > x_lo and y_hi > y_lo:
            self.image[y_lo:y_hi, x_lo:x_hi] = color.as_array()

    # --- Waveforms (reference Graph.cpp:69-150) -----------------------------
    def draw_waveform(self, data, rect: Optional[Rect] = None,
                      plane: int = ALL_PLANES,
                      color: Optional[Color] = None,
                      mode: str = WaveformMode.DIRECT,
                      oversample: int = 4) -> None:
        """Waveform from a 1-D buffer OR a callable of plane x
        (reference Function<float,float> overload, Graph.cpp:69-120),
        pixel-golden vs the compiled reference (buffer overload
        :122-132): per pixel column, the f32 average of `oversample`
        nearest-floor samples (oversample forced to 1 when n < width,
        buffer form only), the AVERAGE clamped to [-1, 1] (individual
        samples are not), fill from the truncated midline pixel toward
        the truncated offset, gated to the view's pixel rows. DIRECT
        fills midline->value (sign-directed); SYMMETRIC fills ±|value|
        from the abs average."""
        if rect is None:
            rect = Rect(0, -1, 1, 1)
        if color is None:
            color = Color.white()
        if callable(data):
            samp = _vectorized1(data)
        else:
            d = np.asarray(data, np.float32)
            n = len(d)
            if n == 0:
                return
            if n < self.width:
                oversample = 1

            def samp(u, _d=d, _n=n):
                i = np.floor((np.float32(u) - np.float32(rect.x1))
                             / np.float32(rect.w)
                             * np.float32(_n)).astype(np.int64)
                # the reference indexes UNCHECKED (UB outside the rect,
                # Graph.cpp:127 commented-out guard); clamp instead
                return _d[np.clip(i, 0, _n - 1)]
        for _, view in self._active_views(rect, plane):
            dr = rect.intersect(view.U)
            x_lo = int(math.ceil(view.x_u_to_v(dr.x1)))
            x_hi = int(math.floor(view.x_u_to_v(dr.x2)))
            xs = np.arange(max(x_lo, 0),
                           max(min(x_hi, self.width), 0))  # [lo, hi)
            if xs.size == 0:
                continue
            # f32 sequential subsample accumulation, as the reference
            acc = np.zeros(len(xs), np.float32)
            for s in range(oversample):
                u = view.x_v_to_u(
                    xs.astype(np.float32)
                    + np.float32(s) / np.float32(oversample))
                v = np.asarray(samp(u), np.float32)
                if mode == WaveformMode.SYMMETRIC:
                    v = np.abs(v)
                acc = (acc + v).astype(np.float32)
            avg = (acc / np.float32(oversample)).astype(np.float32)
            off_u = (np.clip(avg, -1.0, 1.0).astype(np.float32)
                     * np.float32(rect.h) / np.float32(2.0))
            off = np.trunc((off_u * np.float32(view.V.h)
                            / np.float32(view.U.h))).astype(np.int64)
            mid = ((np.float32(rect.y1) + np.float32(rect.y2))
                   / np.float32(2.0))
            row_mid = self._row_trunc(view, float(mid))
            # bottom-up fill [y_mid, y_mid+off] flips to rows
            # [row_mid-off, row_mid] (inclusive both ends)
            if mode == WaveformMode.SYMMETRIC:
                r_lo = row_mid - off
                r_hi = row_mid + off
            else:
                r_lo = np.minimum(row_mid, row_mid - off)
                r_hi = np.maximum(row_mid, row_mid - off)
            vy0, vy1 = int(view.V.y1), int(view.V.y2)
            rows = np.arange(self.height)[:, None]
            mask = ((rows >= r_lo[None, :]) & (rows <= r_hi[None, :])
                    & (rows >= vy0) & (rows < vy1))
            self.image[:, xs[0]:xs[-1] + 1][mask] = color.as_array()

    def draw_waveforms(self, datas: Sequence, rect: Optional[Rect] = None,
                       start_plane: int = 0,
                       mode: str = WaveformMode.DIRECT,
                       oversample: int = 4) -> None:
        for i, d in enumerate(datas):
            c = Color.from_hsv(360.0 * i / len(datas), 0.8, 0.65)
            self.draw_waveform(d, rect, start_plane + i, c, mode,
                               oversample)

    # --- Spectrograms (reference Graph.cpp:157-230) -------------------------
    def draw_spectrogram(self, data, rect: Optional[Rect] = None,
                         plane: int = ALL_PLANES, hue: float = 0.0,
                         oversample: int = 4) -> None:
        """[n_x, n_y] magnitudes OR an (x, y) callable (reference
        Function<vec2,float> overload, Graph.cpp:157-194) -> HSV value
        plane, pixel-golden vs the compiled reference (buffer overload
        :196-208): ceil/floor pixel bounds (end-exclusive),
        int(sqrt(oversample))^2 nearest-floor subsamples averaged in
        f32 per pixel, hue TRUNCATED to int at the from_hsv call
        (Color.h takes int H), value clamped [0, 1]."""
        if callable(data):
            if rect is None:
                rect = Rect(0, 0, 1, 1)
            samp2 = _vectorized2(data)
        else:
            d = np.asarray(data, np.float32)
            n, m = d.shape
            if rect is None:
                rect = Rect(0, 0, n, m)

            def samp2(u, yu, _d=d, _n=n, _m=m):
                i = np.floor((np.float32(u) - np.float32(rect.x1))
                             / np.float32(rect.w)
                             * np.float32(_n)).astype(np.int64)
                j = np.floor((np.float32(yu) - np.float32(rect.y1))
                             / np.float32(rect.h)
                             * np.float32(_m)).astype(np.int64)
                # reference indexes UNCHECKED (Graph.cpp:201
                # commented-out guard); clamp instead
                return _d[np.clip(i, 0, _n - 1), np.clip(j, 0, _m - 1)]
        oc = int(math.sqrt(oversample))
        for _, view in self._active_views(rect, plane):
            dr = rect.intersect(view.U)
            x_lo = int(math.ceil(view.x_u_to_v(dr.x1)))
            x_hi = int(math.floor(view.x_u_to_v(dr.x2)))
            xs = np.arange(max(x_lo, 0),
                           max(min(x_hi, self.width), 0))   # [lo, hi)
            # the reference's y loop runs in BOTTOM-UP pixels
            # [ceil(yUToV(y1)), floor(yUToV(y2))) and set_pixel flips
            yb_lo = int(math.ceil(float(
                (np.float32(dr.y1) - np.float32(view.U.y1))
                * np.float32(view.V.h) / np.float32(view.U.h)
                + np.float32(self.height - view.V.y2))))
            yb_hi = int(math.floor(float(
                (np.float32(dr.y2) - np.float32(view.U.y1))
                * np.float32(view.V.h) / np.float32(view.U.h)
                + np.float32(self.height - view.V.y2))))
            ybs = np.arange(max(yb_lo, 0),
                            max(min(yb_hi, self.height), 0))
            if xs.size == 0 or ybs.size == 0:
                continue
            acc = np.zeros((len(ybs), len(xs)), np.float32)
            for ys_ in range(oc):           # reference nesting order
                for xs_ in range(oc):
                    u = view.x_v_to_u(xs.astype(np.float32)
                                      + np.float32(xs_) / np.float32(oc))
                    yb = (ybs.astype(np.float32)
                          + np.float32(ys_) / np.float32(oc))
                    yu = ((yb - np.float32(self.height - view.V.y2))
                          * np.float32(view.U.h) / np.float32(view.V.h)
                          + np.float32(view.U.y1))
                    v = np.asarray(samp2(u[None, :], yu[:, None]),
                                   np.float32)
                    acc = (acc + v).astype(np.float32)
            mag = (acc / np.float32(oc * oc)).astype(np.float32)
            rgb = hsv_to_rgb(np.full_like(mag, int(hue)),
                             np.ones_like(mag),
                             np.clip(mag, 0.0, 1.0))
            rows = self.height - 1 - ybs                 # flip to rows
            self.image[rows[:, None], xs[None, :]] = rgb

    def draw_spectrograms(self, datas: Sequence,
                          rect: Optional[Rect] = None,
                          start_plane: int = 0,
                          oversample: int = 4) -> None:
        for i, d in enumerate(datas):
            self.draw_spectrogram(d, rect, start_plane + i,
                                  hue=360.0 * i / len(datas),
                                  oversample=oversample)

    # --- Functions (reference Graph.cpp:232-330) ----------------------------
    def draw_function(self, f, domain: Optional[Interval] = None,
                      plane: int = ALL_PLANES,
                      color: Optional[Color] = None) -> None:
        """f: callable over x, or a sequence of (x, y) points which are
        linearly interpolated with a domain exactly fitting the points
        (reference Graph.cpp:260-269 overload via interpolate_points)."""
        if color is None:
            color = Color.black()
        if not callable(f):
            pts = np.asarray(f, np.float64)
            order = np.argsort(pts[:, 0])
            px = pts[order, 0].astype(np.float32)
            py_ = pts[order, 1].astype(np.float32)
            if domain is None:
                domain = Interval(float(px[0]), float(px[-1]))

            def f(x, _px=px, _py=py_):
                # float32 lerp, exactly as interpolate_points
                # (Interpolator.cpp:102-120; pixel-golden): mix =
                # (t-x1)/(x2-x1), out = (1-mix)*y1 + mix*y2, all f32
                t = np.asarray(x, np.float32)
                i = np.clip(np.searchsorted(_px, t, side="left"), 1,
                            len(_px) - 1)
                x1, x2 = _px[i - 1], _px[i]
                mix = ((t - x1) / (x2 - x1)).astype(np.float32)
                out = ((np.float32(1.0) - mix) * _py[i - 1]
                       + mix * _py[i]).astype(np.float32)
                out = np.where(t <= _px[0], _py[0], out)
                return np.where(t >= _px[-1], _py[-1], out)
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf)
                if domain is None else
                Rect(domain.x1, -np.inf, domain.x2, np.inf), plane):
            # reference loop (Graph.cpp:232-258, pixel-golden): one
            # f32-accumulated pixelAdvance step per pixel column; a
            # segment draws only when BOTH endpoints satisfy the
            # HALF-OPEN U.contains — off-view samples break the curve
            d1 = view.U.x1 if domain is None else max(domain.x1,
                                                      view.U.x1)
            d2 = view.U.x2 if domain is None else min(domain.x2,
                                                      view.U.x2)
            adv = np.float32(view.U.w / view.V.w)      # wVToU(1)
            if d2 <= d1:
                continue
            xs = [np.float32(d1)]
            while True:
                nxt = np.float32(xs[-1] + adv)
                if not nxt < d2:
                    break
                xs.append(nxt)
            xs = np.asarray(xs, np.float32)
            try:  # vectorized evaluation when f accepts arrays
                ys = np.asarray(f(xs), np.float64).reshape(-1)
                if ys.shape != xs.shape:
                    raise ValueError
            except Exception:
                ys = np.asarray([float(f(float(x))) for x in xs])
            inside = ((view.U.x1 <= xs) & (xs < view.U.x2)
                      & (view.U.y1 <= ys) & (ys < view.U.y2))
            for i in range(1, len(xs)):
                if inside[i - 1] and inside[i]:
                    self.draw_line_segment(
                        view, float(xs[i - 1]), float(ys[i - 1]),
                        float(xs[i]), float(ys[i]), color)

    def draw_functions(self, fs: Sequence[Callable],
                       domains: Optional[Sequence[Interval]] = None,
                       plane: int = ALL_PLANES) -> None:
        """Graph each function with maximally spaced hues (reference
        Graph.cpp:271-281: hue = 360*f/len, from_hsv(hue, 1, 1); a domain
        list shorter than fs falls back to the full real line)."""
        domains = domains or []
        for i, f in enumerate(fs):
            dom = domains[i] if i < len(domains) else None
            self.draw_function(f, dom, plane,
                               Color.from_hsv(360.0 * i / len(fs), 1.0, 1.0))

    def draw_point(self, p: Tuple[float, float], radius: int = 6,
                   plane: int = ALL_PLANES,
                   color: Optional[Color] = None) -> None:
        """Filled disc with view-independent pixel radius, clamped to each
        view's V rect (reference Graph.cpp:535-564: per-column vertical
        spans of height floor(sqrt(r^2 - dx^2)))."""
        color = color or Color.black()
        x, y = p
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            # Pixel casts TRUNCATE (Graph.cpp:545-546) in bottom-up
            # pixel space before the row flip
            xm = int(view.x_u_to_v(x))
            row_mid = self._row_trunc(view, y)
            vx0, vx1 = int(view.V.x1), int(view.V.x2) - 1
            vy0, vy1 = int(view.V.y1), int(view.V.y2) - 1
            xs = np.arange(np.clip(xm - radius, vx0, vx1),
                           np.clip(xm + radius, vx0, vx1) + 1)
            if xs.size == 0:
                continue
            off = np.floor(np.sqrt(np.maximum(
                radius * radius - (xs - xm) ** 2, 0))).astype(np.int64)
            # bitmap_image's vertical_line_segment END is EXCLUSIVE
            # (pixel-golden vs the compiled reference): each column
            # drops its bottom row, and offset-0 edge columns draw
            # nothing at all
            y_lo = np.clip(row_mid - off, max(vy0, 0), vy1)
            y_hi = np.clip(row_mid + off, vy0, min(vy1, self.height - 1)) \
                - 1
            rows = np.arange(self.height)[:, None]
            in_x = (xs >= 0) & (xs < self.width)
            mask = (rows >= y_lo[None, :]) & (rows <= y_hi[None, :]) \
                & in_x[None, :]
            rr, cc = np.nonzero(mask)
            self.image[rr, xs[cc]] = color.as_array()

    def draw_points(self, points: Sequence[Tuple[float, float]],
                    radius: int = 6, plane: int = ALL_PLANES,
                    color: Optional[Color] = None) -> None:
        for p in points:
            self.draw_point(p, radius, plane, color)

    # --- Axes / grids / ticks (reference Graph.cpp:333-430) -----------------
    def draw_axes(self, plane: int = ALL_PLANES,
                  color: Optional[Color] = None) -> None:
        """Axis lines through 0 with half-open containment gates
        (Graph.cpp:333-346)."""
        if color is None:
            color = Color.black()
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            if view.U.x1 <= 0 < view.U.x2:
                self.draw_vertical_line(view, view.U.y1, view.U.y2, 0.0,
                                        color)
            if view.U.y1 <= 0 < view.U.y2:
                self.draw_horizontal_line(view, view.U.x1, view.U.x2,
                                          0.0, color)

    def draw_linear_grid_x(self, spacing: float, plane: int = ALL_PLANES,
                           color: Optional[Color] = None) -> None:
        """Vertical lines at multiples of spacing, ceil(x1)..floor(x2)
        inclusive (Graph.cpp:350-369)."""
        color = color or Color.black()
        if spacing <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            start = math.ceil(view.U.x1 / spacing) * spacing
            end = math.floor(view.U.x2 / spacing) * spacing
            x = start
            while x <= end:
                self.draw_vertical_line(view, view.U.y1, view.U.y2, x,
                                        color)
                x += spacing

    def draw_linear_grid_y(self, spacing: float, plane: int = ALL_PLANES,
                           color: Optional[Color] = None) -> None:
        """Horizontal lines at multiples of spacing (Graph.cpp:371-391)."""
        color = color or Color.black()
        if spacing <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            start = math.ceil(view.U.y1 / spacing) * spacing
            end = math.floor(view.U.y2 / spacing) * spacing
            y = start
            while y <= end:
                self.draw_horizontal_line(view, view.U.x1, view.U.x2, y,
                                          color)
                y += spacing

    def draw_linear_grid(self, x_spacing: float = 1.0, y_spacing: float = 1.0,
                         plane: int = ALL_PLANES,
                         color: Optional[Color] = None) -> None:
        """Both grids at once (reference Graph.cpp:393-397)."""
        self.draw_linear_grid_x(x_spacing, plane, color)
        self.draw_linear_grid_y(y_spacing, plane, color)

    def draw_log_grid_y(self, spacing: float = 1.0,
                        lines_per_step: int = 10,
                        plane: int = ALL_PLANES,
                        color: Optional[Color] = None) -> None:
        """Horizontal log-subdivided grid (reference Graph.cpp:429-458).
        Preserves the reference's literal subdivision formula
        y = y_cell + log(1+step)/log(lines_per_step), which is NOT scaled
        by `spacing` — subdivisions only fill the cell when spacing == 1
        (documented upstream quirk)."""
        color = color or Color.black()
        if spacing <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            y_start = math.floor(view.U.y1 / spacing) * spacing
            y_end = math.ceil(view.U.y2 / spacing) * spacing
            y_cell = y_start
            while y_cell <= y_end:
                for step in range(int(lines_per_step)):
                    y = y_cell + math.log(1.0 + step) / math.log(
                        lines_per_step)
                    if view.U.y1 <= y < view.U.y2:
                        self.draw_horizontal_line(view, view.U.x1,
                                                  view.U.x2, y, color)
                y_cell += spacing

    def draw_log_grid_x(self, spacing: float = 1.0,
                        lines_per_step: int = 10,
                        plane: int = ALL_PLANES,
                        color: Optional[Color] = None) -> None:
        """Vertical log-subdivided grid (reference Graph.cpp:399-427);
        the same unscaled-subdivision quirk as draw_log_grid_y."""
        color = color or Color.black()
        if spacing <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            x_start = math.floor(view.U.x1 / spacing) * spacing
            x_end = math.ceil(view.U.x2 / spacing) * spacing
            x_cell = x_start
            while x_cell <= x_end:
                for step in range(int(lines_per_step)):
                    x = x_cell + math.log(1.0 + step) / math.log(
                        lines_per_step)
                    if view.U.x1 <= x < view.U.x2:
                        self.draw_vertical_line(view, view.U.y1,
                                                view.U.y2, x, color)
                x_cell += spacing

    # digit stroke paths in a unit box, x1=.15 x2=.85 (reference
    # Graph.cpp:646-690); -1 = minus sign, 10 = decimal dot
    _DIGIT_PATHS = {
        -1: [(.15, .5), (.85, .5)],
        0: [(.15, 0), (.85, 0), (.85, 1), (.15, 1), (.15, 0), (.15, 1)],
        1: [(.5, 0), (.5, 1)],
        2: [(.15, 1), (.85, 1), (.85, .5), (.15, .5), (.15, 0), (.85, 0)],
        3: [(.15, 1), (.85, 1), (.85, .5), (.15, .5), (.85, .5), (.85, 0),
            (.15, 0)],
        4: [(.15, 1), (.15, .5), (.85, .5), (.85, 1), (.85, 0)],
        5: [(.85, 1), (.15, 1), (.15, .5), (.85, .5), (.85, 0), (.15, 0)],
        6: [(.85, 1), (.15, 1), (.15, 0), (.85, 0), (.85, .5), (.15, .5)],
        7: [(.15, 1), (.85, 1), (.5, 0)],
        8: [(.85, .5), (.85, 1), (.15, 1), (.15, 0), (.85, 0), (.85, .5),
            (.15, .5)],
        9: [(.85, .5), (.15, .5), (.15, 1), (.85, 1), (.85, 0)],
        10: [(.4, 0), (.6, 0), (.6, .2), (.4, .2), (.4, 0)],
    }

    def draw_float(self, pos: Tuple[float, float], digit_width: int,
                   digit_height: int, number: float,
                   plane: int = ALL_PLANES,
                   color: Optional[Color] = None) -> None:
        """Primitive stroked-path numeral rendering (reference
        Graph.cpp:596-693): optional minus, whole digits, a dot glyph, and
        exactly three fractional digits from round(frac*1000); a digit box
        leaving the view's U rect aborts the remaining digits."""
        color = color or Color.black()
        negative = number < 0
        number = abs(number)
        q = int(math.floor(number))
        r = int(round((number - q) * 1000.0))
        digits: List[int] = [-1] if negative else []
        digits += [int(c) for c in str(q)]
        digits.append(10)
        digits += [int(c) for c in f"{r:03d}"]
        x, y = np.float32(pos[0]), np.float32(pos[1])
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            # f32 box arithmetic in the reference's order
            # (Graph.cpp:613-645: w = wVToU, y2 = y + hVToU, f32
            # xPos += w accumulation, strokes at x1 + w * px)
            w = np.float32(view.w_v_to_u(digit_width))
            y2 = np.float32(y + np.float32(view.h_v_to_u(digit_height)))
            x_pos = x
            for d in digits:
                box = Rect(float(x_pos), float(y),
                           float(np.float32(x_pos + w)), float(y2))
                clipped = box.intersect(view.U)
                if (clipped.x1, clipped.y1, clipped.x2, clipped.y2) != (
                        box.x1, box.y1, box.x2, box.y2):
                    # the reference RETURNS from the whole call (not just
                    # this view) once a digit leaves the view
                    # (Graph.cpp:647)
                    return
                bw = np.float32(box.w)
                bh = np.float32(box.h)
                ps = self._DIGIT_PATHS.get(
                    d, [(.15, 0), (.85, 0), (.15, 1), (.85, 1), (.15, 0)])
                for (ax, ay), (bx, by) in zip(ps[:-1], ps[1:]):
                    self.draw_line_segment(
                        view,
                        float(np.float32(box.x1)
                              + bw * np.float32(ax)),
                        float(np.float32(box.y1)
                              + bh * np.float32(ay)),
                        float(np.float32(box.x1)
                              + bw * np.float32(bx)),
                        float(np.float32(box.y1)
                              + bh * np.float32(by)), color)
                x_pos = np.float32(x_pos + w)

    def draw_x_ticks(self, jump: float, y: float,
                     scale_base: float = 1.0,
                     offset_down: int = 4, offset_up: int = 4,
                     plane: int = ALL_PLANES,
                     color: Optional[Color] = None,
                     number_scale: float = 0.0) -> None:
        """Vertical tick strokes at multiples of jump along the line
        plane-y, spanning offset_down/offset_up PIXELS converted to
        plane heights and clamped to the view (reference
        Graph.cpp:459-495). With number_scale > 0, each tick is
        labelled pow(scale_base, x) via draw_float 12 pixels below the
        stroke — scale_base 1 labels every tick '1.000' (upstream
        callers pass 1, AudioGraph.cpp:42). f32 x accumulation."""
        color = color or Color.black()
        if jump <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            y_start = float(np.clip(
                np.float32(y) - np.float32(view.h_v_to_u(offset_down)),
                np.float32(view.U.y1), np.float32(view.U.y2)))
            y_end = float(np.clip(
                np.float32(y) + np.float32(view.h_v_to_u(offset_up)),
                np.float32(view.U.y1), np.float32(view.U.y2)))
            x = np.float32(np.ceil(np.float32(view.U.x1)
                                   / np.float32(jump)) * np.float32(jump))
            x_end = np.float32(np.floor(np.float32(view.U.x2)
                                        / np.float32(jump))
                               * np.float32(jump))
            while x <= x_end:
                self.draw_vertical_line(view, y_start, y_end, float(x),
                                        color)
                if number_scale > 0:
                    number = float(np.power(np.float32(scale_base), x))
                    self.draw_float(
                        (float(x),
                         float(np.float32(y_start)
                               - np.float32(view.h_v_to_u(12)))),
                        int(number_scale * 4 / 5), int(number_scale),
                        number, plane, color)
                x = np.float32(x + np.float32(jump))

    def draw_y_ticks(self, jump: float, x: float,
                     scale_base: float = 1.0,
                     offset_left: int = 4, offset_right: int = 4,
                     plane: int = ALL_PLANES,
                     color: Optional[Color] = None,
                     number_scale: float = 0.0) -> None:
        """Horizontal tick strokes at multiples of jump along the line
        plane-x (reference Graph.cpp:497-533); labels pow(scale_base, y)
        at the stroke's right end, half a 10-pixel height below."""
        color = color or Color.black()
        if jump <= 0:
            return
        for _, view in self._active_views(
                Rect(-np.inf, -np.inf, np.inf, np.inf), plane):
            x_start = float(np.clip(
                np.float32(x) - np.float32(view.w_v_to_u(offset_left)),
                np.float32(view.U.x1), np.float32(view.U.x2)))
            x_end = float(np.clip(
                np.float32(x) + np.float32(view.w_v_to_u(offset_right)),
                np.float32(view.U.x1), np.float32(view.U.x2)))
            y = np.float32(np.ceil(np.float32(view.U.y1)
                                   / np.float32(jump)) * np.float32(jump))
            y_end = np.float32(np.floor(np.float32(view.U.y2)
                                        / np.float32(jump))
                               * np.float32(jump))
            while y <= y_end:
                self.draw_horizontal_line(view, x_start, x_end, float(y),
                                          color)
                if number_scale > 0:
                    number = float(np.power(np.float32(scale_base), y))
                    self.draw_float(
                        (x_end,
                         float(y - np.float32(0.5)
                               * np.float32(view.h_v_to_u(10)))),
                        int(number_scale * 4 / 5), int(number_scale),
                        number, plane, color)
                y = np.float32(y + np.float32(jump))

    # --- I/O -----------------------------------------------------------------
    def to_uint8(self) -> np.ndarray:
        return (np.clip(self.image, 0, 1) * 255).astype(np.uint8)

    def save_image(self, filename: str) -> None:
        """Write 24-bit BMP (replaces the vendored bitmap_image writer;
        reference Utility/Bytes.cpp writeBMP)."""
        write_bmp(filename, self.to_uint8())


def write_bmp(filename: str, rgb: np.ndarray) -> None:
    """Bottom-up 24-bit BMP encoder for [H, W, 3] uint8 (native C++ row
    encoder when available; numpy fallback)."""
    import struct
    from flan_tpu import native
    h, w, _ = rgb.shape
    row_size = (3 * w + 3) & ~3
    data_size = row_size * h
    body = native.encode_bmp_rows(rgb)
    if body is None:
        bgr = rgb[::-1, :, ::-1]  # bottom-up rows, BGR order
        rows = np.zeros((h, row_size), np.uint8)
        rows[:, : 3 * w] = bgr.reshape(h, 3 * w)
        body = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + data_size, 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                      2835, 2835, 0, 0)
    with open(filename, "wb") as f:
        f.write(header + dib + body)
