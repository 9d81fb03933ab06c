"""FunctionSample: constant-optimized sampled-function containers.

JAX port of the reference FunctionSample / FunctionSample2d
(reference: src/flan/FunctionSample.h:18-199). A sampled Function is either
a scalar (constant short-circuit, O(1) storage) or a device array; the
container provides the reference's transform/accumulate/scan/maximum
surface on both representations. Most flan_tpu internals work on the raw
arrays directly - this class is the API-parity wrapper.
"""
from __future__ import annotations

from typing import Callable, Union

import jax.numpy as jnp
import numpy as np


class FunctionSample:
    """A constant or a 1-D sampled array."""

    def __init__(self, value, size: int):
        self._size = int(size)
        if np.isscalar(value) or (hasattr(value, "shape")
                                  and value.shape == ()):
            self._const = float(value)
            self._vec = None
        else:
            self._const = None
            self._vec = jnp.asarray(value)

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    def get_constant(self) -> float:
        return self._const

    def as_array(self) -> jnp.ndarray:
        if self._const is not None:
            return jnp.full((self._size,), self._const, jnp.float32)
        return self._vec

    def __len__(self) -> int:
        return self._size

    def __getitem__(self, i):
        if self._const is not None:
            return self._const
        return self._vec[i]

    def transform(self, f: Callable) -> "FunctionSample":
        """(reference FunctionSample.h transform)"""
        if self._const is not None:
            out = f(jnp.float32(self._const))
            return FunctionSample(float(np.asarray(out)), self._size)
        return FunctionSample(f(self._vec), self._size)

    # the reference exposes mutating for_each; immutable arrays make that
    # the same operation as transform
    for_each = transform

    def accumulate(self) -> float:
        if self._const is not None:
            return self._const * self._size
        return float(jnp.sum(self._vec))

    def exclusive_scan(self, init: float = 0.0,
                       op: str = "add") -> "FunctionSample":
        a = self.as_array()
        if op != "add":
            raise ValueError("only additive exclusive_scan is provided")
        scanned = jnp.concatenate(
            [jnp.asarray([init], a.dtype), init + jnp.cumsum(a)[:-1]])
        return FunctionSample(scanned, self._size)

    def maximum(self, key: Callable = None) -> float:
        a = self.as_array()
        if key is not None:
            a = key(a)
        return float(jnp.max(a))


class FunctionSample2d:
    """A constant or a 2-D sampled grid (frames x bins)."""

    def __init__(self, value, num_frames: int, num_bins: int):
        self._shape = (int(num_frames), int(num_bins))
        if np.isscalar(value) or (hasattr(value, "shape")
                                  and value.shape == ()):
            self._const = float(value)
            self._grid = None
        else:
            self._const = None
            self._grid = jnp.asarray(value)

    @property
    def is_constant(self) -> bool:
        return self._const is not None

    def as_array(self) -> jnp.ndarray:
        if self._const is not None:
            return jnp.full(self._shape, self._const, jnp.float32)
        return jnp.broadcast_to(self._grid, self._shape)

    def at(self, frame: int, b: int):
        if self._const is not None:
            return self._const
        return self.as_array()[frame, b]

    def transform(self, f: Callable) -> "FunctionSample2d":
        if self._const is not None:
            return FunctionSample2d(float(np.asarray(
                f(jnp.float32(self._const)))), *self._shape)
        return FunctionSample2d(f(self._grid), *self._shape)

    for_each = transform

    def maximum(self, key: Callable = None) -> float:
        a = self.as_array()
        if key is not None:
            a = key(a)
        return float(jnp.max(a))
