"""Function layer: constant-or-callable algorithm parameters.

JAX re-design of the reference's Function<I, O> system
(reference: src/flan/Function.h:35-300, FunctionSample.h:18-199). The
reference stores a std::variant<constant, std::function> plus an execution
policy and rasterizes onto frame grids with parallel STL. Here a Function
wraps a constant or a JAX-traceable callable; rasterization is one vmapped
evaluation on a device grid, and XLA owns scheduling, so the ExecutionPolicy
enum disappears (SURVEY.md section 7).

Constants short-circuit: sampling a constant returns a scalar, which keeps
downstream ops cheap exactly like the reference's variant fast path.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

FunctionLike = Union[float, int, "Function", Callable]


class Function:
    """A constant or a callable over one scalar input (usually time)."""

    def __init__(self, f: FunctionLike):
        if isinstance(f, Function):
            self._const = f._const
            self._fn = f._fn
        elif callable(f):
            self._const = None
            self._fn = f
        else:
            try:
                self._const = float(f)
                self._fn = None
            except jax.errors.ConcretizationTypeError:
                # a traced scalar (a parameter under jax.grad/jit)
                # cannot be concretized; treat it as a time-varying
                # callable so algorithms take their general sampled
                # path, which is traced and therefore differentiable
                # in the parameter
                self._const = None
                self._fn = lambda x, _v=f: jnp.broadcast_to(
                    jnp.asarray(_v, jnp.float32), jnp.shape(x))

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    @property
    def constant_value(self) -> float:
        return self._const

    def __call__(self, x):
        if self._const is not None:
            return (jnp.full(jnp.shape(x), self._const, jnp.float32)
                    if hasattr(x, "shape") or isinstance(x, (list, tuple))
                    else self._const)
        return self._fn(x)

    def sample(self, start: int, end: int, period: float):
        """Rasterize onto the grid (start..end-1) * period.

        Matches reference Function::sample (Function.h:139-187). Constants
        return a python float; callables return a [end-start] float32 array.
        """
        if self._const is not None:
            return self._const
        grid = jnp.arange(start, end, dtype=jnp.float32) * period
        return _vector_eval(self._fn, grid)

    def sample_device(self, count: int, period: float):
        """Rasterize onto (0..count-1) * period as a DEVICE [count] f32
        array (constants short-circuit to jnp.full - no host staging:
        every host array is its own host->device transfer). The shared helper for per-frame control
        sampling in synthesis/temporal methods."""
        if self._const is not None:
            return jnp.full((count,), float(self._const), jnp.float32)
        grid = jnp.arange(count, dtype=jnp.float32) * period
        return jnp.broadcast_to(
            jnp.asarray(_vector_eval(self._fn, grid), jnp.float32),
            (count,))

    def copy(self) -> "Function":
        """Reference Function::copy (Function.h:65-72); Functions here are
        immutable so this is a fresh wrapper over the same underlying."""
        return Function(self)

    def periodize(self, period: float = 1.0) -> "Function":
        """Repeat this function with the given period (Function.h:128-137)."""
        if self._const is not None:
            return self
        fn = self._fn
        return Function(lambda t: fn(jnp.mod(t, period)))

    @staticmethod
    def uniform_distribution(lower: FunctionLike, upper: FunctionLike,
                             seed: int = 0) -> "Function":
        """Stochastic Function drawing uniform values between the bounds,
        evaluated per call (activates the reference's commented-out
        Function::uniformDistribution, Function.h:105-112). The reference
        seeds a shared engine with time(nullptr); here the seed is
        explicit and the draw happens on host at evaluation time (the
        values embed as constants under tracing)."""
        lo, hi = as_function(lower), as_function(upper)
        rng = np.random.default_rng(seed)

        def f(x):
            u = rng.random(np.shape(x)).astype(np.float32)
            a = np.asarray(lo(x), np.float32)
            b = np.asarray(hi(x), np.float32)
            out = a + (b - a) * u
            return out if np.shape(x) else float(out)
        return Function(f)

    @staticmethod
    def normal_distribution(mean: FunctionLike, sigma: FunctionLike,
                            seed: int = 0) -> "Function":
        """Stochastic Function drawing normal(mean, sigma) per call, with
        the reference's sigma<=0 -> mean short-circuit (activates the
        commented-out Function::normalDistribution, Function.h:114-125)."""
        m_f, s_f = as_function(mean), as_function(sigma)
        rng = np.random.default_rng(seed)

        def f(x):
            m = np.asarray(m_f(x), np.float32)
            s = np.asarray(s_f(x), np.float32)
            z = rng.standard_normal(np.shape(x)).astype(np.float32)
            out = np.where(s > 0, m + s * z, m)
            return out if np.shape(x) else float(out)
        return Function(f)

    # camelCase aliases matching the reference's declared names are bound
    # after the class body (Function.uniformDistribution/...).

    def convert_to_graph(self, view=None, domain=None,
                         width: int = -1, height: int = -1):
        """Graph this function (reference Function.h:197-211: white fill,
        unit linear grid in light grey, axes, function in black)."""
        from flan_tpu.graph import Graph
        from flan_tpu.utils.geometry import Color, Rect
        if view is None:
            view = Rect(-5, -5, 5, 5)
        g = Graph(width, height)
        g.set_view(view)
        g.fill_image(Color.white())
        g.draw_linear_grid(1, 1, 0, Color(200 / 255, 200 / 255, 200 / 255))
        g.draw_axes(0, Color.black())
        g.draw_function(self, domain, -1, Color.black())
        return g

    def save_to_bmp(self, filename: str, view=None, domain=None,
                    width: int = -1, height: int = -1) -> None:
        """Graph and save (reference Function.h:222-231)."""
        self.convert_to_graph(view, domain, width, height).save_image(
            filename)

    # Arithmetic composition helpers
    def __mul__(self, other):
        return _binary(self, other, lambda a, b: a * b)

    def __add__(self, other):
        return _binary(self, other, lambda a, b: a + b)

    def __neg__(self):
        if self._const is not None:
            return Function(-self._const)
        fn = self._fn
        return Function(lambda t: -fn(t))


Function.uniformDistribution = Function.uniform_distribution
Function.normalDistribution = Function.normal_distribution


def _binary(left: "Function", right, op) -> "Function":
    """Compose two Functions (or a Function and a constant) pointwise."""
    r = as_function(right)
    if left.is_constant and r.is_constant:
        return Function(float(op(left.constant_value, r.constant_value)))
    return Function(lambda t: op(left(t), r(t)))


class Function2d:
    """A constant or a callable over (time, frequency) pairs.

    Mirrors Function<TF, O> (reference Function.h, TF defined defines.h).
    Callables take (t, f) broadcastable arrays.
    """

    def __init__(self, f: FunctionLike):
        if isinstance(f, Function2d):
            self._const = f._const
            self._fn = f._fn
        elif isinstance(f, Function):
            self._const = f._const
            fn = f._fn
            self._fn = None if fn is None else (lambda t, fr: fn(t))
        elif callable(f):
            self._const = None
            self._fn = f
        else:
            try:
                self._const = float(f)
                self._fn = None
            except jax.errors.ConcretizationTypeError:
                # traced scalar parameter: same differentiable fallback
                # as Function above
                self._const = None
                self._fn = lambda t, fr, _v=f: jnp.broadcast_to(
                    jnp.asarray(_v, jnp.float32),
                    jnp.broadcast_shapes(jnp.shape(t), jnp.shape(fr)))

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    @property
    def constant_value(self) -> float:
        return self._const

    def __call__(self, t, f):
        if self._const is not None:
            shape = jnp.broadcast_shapes(jnp.shape(t), jnp.shape(f))
            return jnp.full(shape, self._const, jnp.float32)
        return self._fn(t, f)

    def sample_grid(self, num_frames: int, frame_period: float,
                    num_bins: int, bin_width: float):
        """Rasterize over the frame x bin grid.

        Matches Function::sample 2d (Function.h:157-187): returns a python
        float for constants, else a [num_frames, num_bins] float32 array.
        """
        if self._const is not None:
            return self._const
        t = jnp.arange(num_frames, dtype=jnp.float32) * frame_period
        f = jnp.arange(num_bins, dtype=jnp.float32) * bin_width
        return _vector_eval2(self._fn, t[:, None], f[None, :])


def _vector_eval(fn, grid):
    """Evaluate fn on an array, falling back to per-element numpy."""
    try:
        out = fn(grid)
        out = jnp.asarray(out, jnp.float32)
        return jnp.broadcast_to(out, grid.shape)
    except Exception:
        g = np.asarray(grid)
        return jnp.asarray([float(fn(float(x))) for x in g], jnp.float32)


def _vector_eval2(fn, t, f):
    try:
        out = jnp.asarray(fn(t, f), jnp.float32)
        return jnp.broadcast_to(
            out, jnp.broadcast_shapes(jnp.shape(t), jnp.shape(f)))
    except Exception:
        tn, fn_grid = np.broadcast_arrays(np.asarray(t), np.asarray(f))
        flat = [float(fn(float(a), float(b)))
                for a, b in zip(tn.ravel(), fn_grid.ravel())]
        return jnp.asarray(flat, jnp.float32).reshape(tn.shape)


def as_function(f: FunctionLike) -> Function:
    return f if isinstance(f, Function) else Function(f)


def as_function2d(f) -> Function2d:
    return f if isinstance(f, Function2d) else Function2d(f)


# --- ADSR (reference Function.h:281-300, Function.cpp) -----------------------
def adsr(attack_time: float, decay_time: float, sustain_time: float,
         release_time: float, sustain_level: float,
         attack_exponent: float = 1.0, decay_exponent: float = 1.0,
         release_exponent: float = 1.0) -> Function:
    """ADSR envelope Function from 0 to 1 with power curves."""
    a, d, s, r = attack_time, decay_time, sustain_time, release_time

    def env(t):
        t = jnp.asarray(t, jnp.float32)
        attack = jnp.where(
            a > 0, jnp.power(jnp.clip(t / jnp.maximum(a, 1e-20), 0, 1),
                             attack_exponent), 1.0)
        # curve shape matches the reference exactly (Function.cpp:21-29):
        # decay   pow(1 - x, dExp) * (1 - sLvl) + sLvl
        # release pow(1 - x, rExp) * sLvl
        # (NOT 1 - (1-s)*pow(x, e) — differs for any exponent != 1)
        decay = sustain_level + (1.0 - sustain_level) * jnp.power(
            1.0 - jnp.clip((t - a) / jnp.maximum(d, 1e-20), 0, 1),
            decay_exponent)
        release = sustain_level * jnp.power(
            1.0 - jnp.clip((t - a - d - s) / jnp.maximum(r, 1e-20), 0, 1),
            release_exponent)
        out = jnp.where(t < a, attack,
                        jnp.where(t < a + d, decay,
                                  jnp.where(t < a + d + s, sustain_level,
                                            release)))
        return jnp.where((t < 0) | (t > a + d + s + r), 0.0, out)

    return Function(env)


# --- Waveforms (reference Function.h:295-300; period and amplitude 1) --------
class waveforms:
    @staticmethod
    def sine(t):
        return jnp.sin(2.0 * jnp.pi * jnp.asarray(t, jnp.float32))

    @staticmethod
    def square(t):
        return jnp.where(jnp.mod(jnp.asarray(t, jnp.float32), 1.0) < 0.5,
                         -1.0, 1.0)

    @staticmethod
    def saw(t):
        return 2.0 * jnp.mod(jnp.asarray(t, jnp.float32), 1.0) - 1.0

    @staticmethod
    def triangle(t):
        m = jnp.mod(jnp.asarray(t, jnp.float32), 1.0)
        return jnp.where(m < 0.5, 4.0 * m - 1.0, 3.0 - 4.0 * m)
