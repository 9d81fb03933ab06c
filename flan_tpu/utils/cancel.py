"""Cooperative cancellation for host-side loops.

The reference threads an std::atomic<bool> canceller through every long
algorithm and polls it between hops/frames
(reference: src/flan/defines.h:49-62, e.g. Conversions/AudioPV.cpp:49).

Design decision for the compiled device path:
a compiled XLA program is not cooperatively interruptible — once a jitted
scan is dispatched it runs to completion, so a per-hop cancel point inside
the fused pipelines has no analog (inserting host callbacks into the scan
would serialize the device against the host and destroy the streaming
throughput). Cancellation is therefore honored at every HOST-side loop
boundary instead: between clips in the CLI batch path, and anywhere else
Python iterates device dispatches. The granularity is one dispatch
(seconds of audio) rather than one hop (milliseconds) — the right
trade for an offline batch library.
"""
from __future__ import annotations

import threading


class CancelToken:
    """Thread-safe cooperative cancellation flag
    (reference defines.h:49-62 flan_CANCEL_ARG/flan_CANCEL_POINT)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise Cancelled if cancel() was called (the flan_CANCEL_POINT
        analog for host-side loops)."""
        if self._event.is_set():
            raise Cancelled()


class Cancelled(Exception):
    """Raised by CancelToken.check() at a host-side cancel point."""
