"""Verify-pipeline span profiler: where a claim wave's wall time goes.

A copy of ``hotstuff_tpu.telemetry.spans``: a ring-buffered span
recorder the verify pipeline threads through every hop from claim
arrival to the device's verdict lanes.  The stage names are the
reference's (``telemetry/taxonomy.py``), so a waterfall reads the same
on both packages.

Span taxonomy (leaf stages sum to the wave's end-to-end time)::

    coalesce.wait    first submit -> the dispatcher collects the batch
    native.pack      adopting a wave from a native ingest arena
    route.decide     the device-vs-CPU routing decision
    pipeline.wait    a device-preferred wave waiting for a free slot
    stage.pack       wave padding to the fixed bucket shape
    stage.slot_wait  dispatch-loop handoff -> slot thread entry
    flatten          claims -> flat (digest, pk, sig) arrays
    prepare          host staging: key-row lookup, hashing, padding, H2D
    dispatch         kernel launch (device enqueue)
    device.execute   waiting for the device to finish the launch
    readback         device -> host copy of the verdict lanes
    host.verify      CPU evaluation (inline route / fallback / hybrid)
    verdict.fanout   worker completion -> every waiter's future resolved

plus parent spans (``e2e``, ``dispatch.wall``) that frame the leaves but
are excluded from waterfall sums, and ``pipeline.occupancy``, whose
duration field holds a count (in-flight waves).

Design constraints (same contract as the journal):

- **Off by default.**  ``HOTSTUFF_PROFILE=1`` / ``--profile`` /
  :func:`enable` turn it on.  Disabled, :func:`span` returns one shared
  no-op context manager and :func:`recorder` returns ``None`` — no
  allocation, no clock reads, a single module-global test per call site.
- **Bounded.**  Completed spans land in a ``deque(maxlen=capacity)``
  ring (default 65536): a run that outlives the ring loses its OLDEST
  spans, a flight recorder, not an archive.
- **Thread-correct.**  The dispatcher's event loop and the slot threads
  both record; ``perf_counter_ns`` is CLOCK_MONOTONIC (cross-thread
  consistent) and per-thread nesting depth lives in a
  ``threading.local``.

Fan-out when a span completes (both optional, both pull their switches
once): a ``verify_stage_ms{stage=...}`` histogram in the telemetry
registry, and — when a journal is attached — an ``{"e":"span"}`` record
whose ``u`` field carries the duration, rendered by
``benchmark/traces.py`` as a per-node "verify pipeline" track aligned
with the consensus rounds.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import nullcontext

from .taxonomy import (
    SPAN_ANNOTATION_STAGES as ANNOTATION_STAGES,
    SPAN_LEAF_STAGES as LEAF_STAGES,
    SPAN_PARENT_STAGES as PARENT_STAGES,
)

DEFAULT_CAPACITY = 65536

#: stage-duration histogram bounds in MILLISECONDS: 1 us doubling up to
#: ~134 s — one ladder below the consensus LATENCY_BOUNDS_S so sub-0.1 ms
#: device stages (dispatch ~50 us) don't collapse into the first bucket
STAGE_BOUNDS_MS: tuple[float, ...] = tuple(1e-3 * 2**i for i in range(28))

# the stage tables themselves (leaf pipeline order, parent frames, value
# annotations) live in telemetry/taxonomy.py, re-exported above

_RECORDER: "SpanRecorder | None" = None
_ENV_CHECKED = False
_SINK = None  # journal fan-out: fn(stage, dur_ns), set via attach_journal
_NULL = nullcontext()  # the shared disabled-path context (reentrant)


def _env_on() -> bool:
    env = os.environ.get("HOTSTUFF_PROFILE")
    return env is not None and env.strip().lower() not in (
        "", "0", "false", "no", "off",
    )


def recorder() -> "SpanRecorder | None":
    """The live recorder, or None when profiling is off.  Call sites
    guard manual timing with ``rec = spans.recorder(); if rec is not
    None: ...`` — the disabled path is one global read (plus a one-time
    env check the first call pays)."""
    global _RECORDER, _ENV_CHECKED
    if _RECORDER is not None:
        return _RECORDER
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        if _env_on():
            _RECORDER = SpanRecorder()
    return _RECORDER


def span(name: str):
    """``with spans.span("prepare"): ...`` — a timed span when profiling
    is on, the shared no-op context otherwise (no allocation)."""
    rec = recorder()
    return _NULL if rec is None else rec.span(name)


def enabled() -> bool:
    return recorder() is not None


def enable(capacity: int = DEFAULT_CAPACITY) -> "SpanRecorder":
    """Force-enable profiling (the CLI's --profile and the profile
    bench call this); idempotent — an existing recorder is kept."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = SpanRecorder(capacity)
    return _RECORDER


def disable() -> None:
    """Drop the recorder and re-arm the env check (tests)."""
    global _RECORDER, _ENV_CHECKED, _SINK
    _RECORDER = None
    _ENV_CHECKED = False
    _SINK = None


def attach_journal(journal) -> None:
    """Fan completed spans out into ``journal`` as ``{"e":"span"}``
    records (stage in ``p``, duration ns in ``u``).  First journal wins:
    spans are process-wide (the verify service is shared across a
    co-located committee), so the whole pipeline renders as ONE track
    pinned to the first journaled node."""
    global _SINK
    if _SINK is None and journal is not None:
        _SINK = lambda stage, dur_ns: journal.record(
            "span", 0, None, stage, dur_ns=dur_ns
        )


class _Span:
    """One live span (context manager).  Cheap by construction: two
    clock reads, a thread-local depth bump, one ring append on exit."""

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
        self._rec._emit(self.name, self.t0, dur, self.depth)


class SpanRecorder:
    """Ring buffer of completed spans ``(name, t0_ns, dur_ns, depth,
    thread)`` with optional metric/journal fan-out."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._local = threading.local()
        self.spans_total = 0
        # None = undecided (checked on the first span so tests that
        # enable telemetry before profiling are seen); False = off
        self._metrics_on: bool | None = None
        self._hists: dict[str, object] = {}

    # ---- recording -------------------------------------------------------

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, t0_ns: int, dur_ns: int) -> None:
        """A manually-timed span (stages whose start predates the code
        that can observe them, e.g. coalesce.wait from submit stamps)."""
        self._emit(name, t0_ns, max(0, int(dur_ns)), 0)

    def _emit(self, name: str, t0_ns: int, dur_ns: int, depth: int) -> None:
        self._ring.append(
            (name, t0_ns, dur_ns, depth, threading.current_thread().name)
        )
        self.spans_total += 1
        if self._metrics_on is None:
            from .. import telemetry

            self._metrics_on = telemetry.enabled()
        if self._metrics_on:
            hist = self._hists.get(name)
            if hist is None:
                from .. import telemetry

                hist = self._hists[name] = telemetry.registry().histogram(
                    "verify_stage_ms",
                    "Verify-pipeline stage durations (milliseconds)",
                    {"stage": name},
                    bounds=STAGE_BOUNDS_MS,
                )
            # annotation stages carry a value in the dur field, not
            # nanoseconds — observe it raw (e.g. in-flight wave depth)
            hist.observe(
                dur_ns if name in ANNOTATION_STAGES else dur_ns / 1e6
            )
        sink = _SINK
        if sink is not None:
            try:
                sink(name, dur_ns)
            except Exception:  # noqa: BLE001 — profiling must never kill
                pass  # the pipeline it observes

    # ---- draining --------------------------------------------------------

    def snapshot(self) -> list[tuple]:
        return list(self._ring)

    def drain(self) -> list[tuple]:
        out = list(self._ring)
        self._ring.clear()
        return out

    def stats(self) -> dict:
        return {
            "spans": self.spans_total,
            "buffered": len(self._ring),
            "capacity": self.capacity,
            "dropped": max(0, self.spans_total - self.capacity),
        }


__all__ = [
    "SpanRecorder",
    "DEFAULT_CAPACITY",
    "STAGE_BOUNDS_MS",
    "LEAF_STAGES",
    "PARENT_STAGES",
    "ANNOTATION_STAGES",
    "recorder",
    "span",
    "enabled",
    "enable",
    "disable",
    "attach_journal",
]
