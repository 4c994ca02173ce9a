"""Verify-pipeline span recorder: where a verify call's wall time goes.

A reduced copy of ``hotstuff_tpu.telemetry.spans``: only what
``gpu.ed25519.BatchVerifier`` and ``crypto.async_service`` use
(``recorder()``, ``span()``, ``SpanRecorder.add``, and the switches that
turn recording on and off).  The stage names are the reference's, so a
waterfall reads the same on both packages:

    prepare          host staging: key-row lookup, hashing, padding, H2D
    dispatch         kernel launch (device enqueue)
    device.execute   waiting for the device to finish the launch
    readback         device -> host copy of the verdict lanes
    host.verify      CPU evaluation (the hybrid route for small batches)

and, from the wave service: ``flatten``, ``route.decide``,
``stage.pack``, ``stage.slot_wait``, ``dispatch.wall``,
``coalesce.wait``, ``pipeline.wait``, ``verdict.fanout`` and ``e2e``
(and ``pipeline.occupancy``, whose duration field holds a count).

Off by default: :func:`enable` turns it on.  Disabled, :func:`span`
returns one shared no-op context and :func:`recorder` returns ``None``.
Completed spans land in a bounded ring
``(name, t0_ns, dur_ns, depth, thread)``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext

DEFAULT_CAPACITY = 65536

_RECORDER: "SpanRecorder | None" = None
_NULL = nullcontext()  # the shared disabled-path context (reentrant)


def recorder() -> "SpanRecorder | None":
    """The live recorder, or None when profiling is off."""
    return _RECORDER


def span(name: str):
    """``with spans.span("prepare"): ...`` — a timed span when profiling
    is on, the shared no-op context otherwise (no allocation)."""
    rec = recorder()
    return _NULL if rec is None else rec.span(name)


def enable(capacity: int = DEFAULT_CAPACITY) -> "SpanRecorder":
    """Force-enable profiling; an existing recorder is kept."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = SpanRecorder(capacity)
    return _RECORDER


def disable() -> None:
    """Drop the recorder."""
    global _RECORDER
    _RECORDER = None


class _Span:
    __slots__ = ("_rec", "name", "t0", "depth")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec = rec
        self.name = name
        self.t0 = 0
        self.depth = 0

    def __enter__(self) -> "_Span":
        local = self._rec._local
        self.depth = getattr(local, "depth", 0)
        local.depth = self.depth + 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter_ns() - self.t0
        self._rec._local.depth = self.depth
        self._rec._ring.append(
            (self.name, self.t0, dur, self.depth, threading.current_thread().name)
        )


class SpanRecorder:
    """Ring buffer of completed spans."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._local = threading.local()

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, t0_ns: int, dur_ns: int) -> None:
        """A manually-timed span (stages whose start predates the code
        that can observe them, e.g. coalesce.wait from submit stamps)."""
        self._ring.append(
            (name, t0_ns, max(0, int(dur_ns)), 0, threading.current_thread().name)
        )

    def drain(self) -> list[tuple]:
        out = list(self._ring)
        self._ring.clear()
        return out


__all__ = ["SpanRecorder", "recorder", "span", "enable", "disable"]
