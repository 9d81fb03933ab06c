"""Geometry and color utilities for graphing.

JAX port surface of the reference utility types
(reference: src/flan/Utility/vec2.h, Interval.h, Rect.h, View.h, Color.h).
Python tuples/dataclasses replace the C++ vector types; HSV conversion is
vectorized numpy for whole-image colorization.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Interval:
    """[x1, x2] interval (reference Interval.h)."""
    x1: float = 0.0
    x2: float = 1.0

    @property
    def w(self) -> float:
        return self.x2 - self.x1

    @staticmethod
    def R() -> "Interval":
        return Interval(-math.inf, math.inf)

    def __mul__(self, other: "Interval") -> "Rect":
        return Rect(self.x1, other.x1, self.x2, other.x2)


@dataclass(frozen=True)
class Rect:
    """Axis-aligned plane rectangle (reference Rect.h)."""
    x1: float = 0.0
    y1: float = 0.0
    x2: float = 1.0
    y2: float = 1.0

    @property
    def w(self) -> float:
        return self.x2 - self.x1

    @property
    def h(self) -> float:
        return self.y2 - self.y1

    def intersect(self, o: "Rect") -> "Rect":
        return Rect(max(self.x1, o.x1), max(self.y1, o.y1),
                    min(self.x2, o.x2), min(self.y2, o.y2))

    def valid(self) -> bool:
        return self.x2 > self.x1 and self.y2 > self.y1


@dataclass(frozen=True)
class View:
    """Maps plane space U to pixel space V (reference View.h). Pixel y
    grows downward; plane y grows upward."""
    U: Rect = Rect()
    V: Rect = Rect()  # pixel rect: x1,y1 top-left; x2,y2 bottom-right

    def x_u_to_v(self, x):
        # FLOAT32 with the reference's operation order (View.h:15-21:
        # (x - U.x1) * V.w / U.w + V.x1) — pixel-golden vs the compiled
        # reference; f64 here lands on the other side of f32
        # round-to-even ties at pixel boundaries
        w = np.float32(x) - np.float32(self.U.x1)
        return ((w * np.float32(self.V.w)) / np.float32(self.U.w)
                + np.float32(self.V.x1))

    def y_u_to_v(self, y):
        # the reference flips with height()-1 (Graph.cpp:297-305), so
        # the bottom plane edge lands on the LAST row, not one past it;
        # f32 like x_u_to_v
        h = np.float32(y) - np.float32(self.U.y1)
        return (np.float32(self.V.y2 - 1)
                - (h * np.float32(self.V.h)) / np.float32(self.U.h))

    def x_v_to_u(self, px):
        # f32, reference order (View.h:17-23: (x - V.x1) * U.w / V.w
        # + U.x1)
        w = np.float32(px) - np.float32(self.V.x1)
        return ((w * np.float32(self.U.w)) / np.float32(self.V.w)
                + np.float32(self.U.x1))

    def y_v_to_u(self, py):
        # inverse of y_u_to_v's height-1 flip; f32 like x_v_to_u
        h = np.float32(self.V.y2 - 1) - np.float32(py)
        return ((h * np.float32(self.U.h)) / np.float32(self.V.h)
                + np.float32(self.U.y1))

    def w_v_to_u(self, px):
        """Pixel width -> plane width (reference View.h:17 wVToU),
        f32 in the reference order (w * U.w) / V.w."""
        return ((np.float32(px) * np.float32(self.U.w))
                / np.float32(self.V.w))

    def h_v_to_u(self, px):
        """Pixel height -> plane height (reference View.h:18 hVToU),
        f32 in the reference order (h * U.h) / V.h."""
        return ((np.float32(px) * np.float32(self.U.h))
                / np.float32(self.V.h))


@dataclass(frozen=True)
class Color:
    """RGB color in [0, 1] (reference Color.h)."""
    r: float = 1.0
    g: float = 1.0
    b: float = 1.0

    @staticmethod
    def from_hsv(h: float, s: float, v: float) -> "Color":
        rgb = hsv_to_rgb(np.asarray([h]), np.asarray([s]), np.asarray([v]))
        return Color(float(rgb[0, 0]), float(rgb[0, 1]), float(rgb[0, 2]))

    @staticmethod
    def white() -> "Color":
        return Color(1.0, 1.0, 1.0)

    @staticmethod
    def black() -> "Color":
        return Color(0.0, 0.0, 0.0)

    def as_array(self) -> np.ndarray:
        return np.asarray([self.r, self.g, self.b], np.float32)


def hsv_to_rgb(h, s, v) -> np.ndarray:
    """Vectorized HSV (h in degrees) -> RGB [..., 3] in [0, 1]."""
    h = np.mod(np.asarray(h, np.float64), 360.0) / 60.0
    s = np.clip(np.asarray(s, np.float64), 0, 1)
    v = np.clip(np.asarray(v, np.float64), 0, 1)
    i = np.floor(h).astype(np.int64) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1).astype(np.float32)
