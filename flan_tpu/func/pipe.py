"""Pipe: composable effect chains.

JAX port of the reference Pipe
(reference: src/flan/Pipe.h:14-44). The C++ version chains callables with
operator>> to exploit rvalue inputs; the Python version composes pure
functions - JAX buffers are immutable so there is nothing to move, and a
fully composed Pipe can be jit-compiled as one fused program.
"""
from __future__ import annotations

from typing import Callable, List


class Pipe:
    """Composable transform: Pipe(f) >> Pipe(g) applies f then g.

    Any callable taking and returning a buffer object (Audio, PV, ...)
    can participate; plain callables compose via >> automatically.
    """

    def __init__(self, *stages: Callable):
        self.stages: List[Callable] = list(stages)

    def __call__(self, x):
        for stage in self.stages:
            x = stage(x)
        return x

    def __rshift__(self, other) -> "Pipe":
        stages = other.stages if isinstance(other, Pipe) else [other]
        return Pipe(*self.stages, *stages)

    def __rrshift__(self, other):
        """buffer >> pipe applies the pipe; callable >> pipe prepends."""
        if callable(other) and not hasattr(other, "data") \
                and not hasattr(other, "mag"):
            return Pipe(other, *self.stages)
        return self(other)
