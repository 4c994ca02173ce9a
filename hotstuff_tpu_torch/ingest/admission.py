"""Admission controller: credit-window backpressure for the producer path.

The proposer's payload buffer is the system's front-door queue.  Before
this controller existed the queue had exactly one overload behavior:
silently drop the newest payload at ``MAX_PENDING``
(consensus/proposer.py) — the client kept paying for transactions that
were never going to commit and had no signal to slow down.  The
controller turns that cliff into a control loop:

- **Occupancy** comes from the proposer's live buffer (bound after the
  proposer is constructed — the receiver boots first in
  Consensus.spawn).
- **Drain rate** is a time-decayed EWMA of committed payloads, fed from
  the proposer's Cleanup messages (every commit carries the committed
  digest set).
- **admit(n)** is a pure function of (occupancy, drain rate, n): accept
  up to the high-watermark headroom, shed the rest with a typed BUSY,
  and quote a retry-after derived from how long the drain rate needs to
  clear the excess.  The credit window quoted back to the client is
  ``min(headroom, drain_rate x horizon)`` — enough inventory to keep
  the proposer busy for one credit horizon, never more than the buffer
  can hold below the watermark.

Determinism: admit() consults an injectable clock only through the
EWMA, and the decision itself depends only on the three inputs above —
the shed/accept split for a given state is exactly reproducible (the
unit tests drive it with a fake clock).

A copy of ``hotstuff_tpu.ingest.admission``, its flight-recorder
journal records included.

Env knobs (read once at construction, env-first like every other knob):
  HOTSTUFF_INGEST_WATERMARK   fraction of capacity where shedding
                              starts (default 0.75)
  HOTSTUFF_INGEST_HORIZON_MS  credit horizon (default 500 ms)
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

#: floor of the credit window: with no commit history yet (cold boot)
#: clients may still submit this many payloads per ACK round trip
MIN_CREDIT = 64
#: retry-after clamp (ms): never tell a client to hammer faster than
#: RETRY_MIN, never park it longer than RETRY_MAX
RETRY_MIN_MS = 10
RETRY_MAX_MS = 5_000
#: commit-rate EWMA time constant (s)
RATE_TAU_S = 2.0
#: journal sampling: one ingest.credit record per this many decisions
CREDIT_SAMPLE_EVERY = 64


class Decision(NamedTuple):
    """Outcome of one admit() call — mirrored onto the ingest ACK."""

    accepted: int
    shed: int
    credit: int
    retry_after_ms: int

    @property
    def busy(self) -> bool:
        return self.shed > 0


class AdmissionController:
    def __init__(
        self,
        capacity: int = 100_000,
        watermark: float | None = None,
        horizon_ms: float | None = None,
        time_fn: Callable[[], float] = time.monotonic,
        journal=None,
    ):
        if watermark is None:
            watermark = _env_float("HOTSTUFF_INGEST_WATERMARK", 0.75)
        if horizon_ms is None:
            horizon_ms = _env_float("HOTSTUFF_INGEST_HORIZON_MS", 500.0)
        self.capacity = max(1, capacity)
        self.watermark = min(1.0, max(0.01, watermark))
        self.horizon_s = max(0.001, horizon_ms / 1e3)
        self._time = time_fn
        self.journal = journal
        self._occupancy: Callable[[], int] | None = None
        # commit-drain EWMA (payloads/s) + its last feed time
        self.commit_rate = 0.0
        self._rate_at: float | None = None
        # counters (telemetry gauges read these; stats() snapshots them)
        self.accepted_total = 0
        self.shed_total = 0
        self.busy_frames = 0
        self.decisions = 0
        self.last_credit = 0

    def bind(
        self, occupancy_fn: Callable[[], int], capacity: int | None = None
    ) -> None:
        """Attach the proposer's live buffer once it exists (the
        receiver — and with it this controller — boots first)."""
        self._occupancy = occupancy_fn
        if capacity is not None:
            self.capacity = max(1, capacity)

    # ---- drain-rate estimation --------------------------------------------

    def on_committed(self, n: int, now: float | None = None) -> None:
        """Feed ``n`` freshly committed payloads into the drain EWMA."""
        if n <= 0:
            return
        if now is None:
            now = self._time()
        if self._rate_at is None:
            self._rate_at = now
            self.commit_rate = 0.0
            return
        dt = now - self._rate_at
        self._rate_at = now
        if dt <= 0:
            return
        inst = n / dt
        alpha = min(1.0, dt / RATE_TAU_S)
        self.commit_rate += alpha * (inst - self.commit_rate)

    # ---- the decision ------------------------------------------------------

    def admit(self, requested: int) -> Decision:
        """Admit up to the watermark headroom; shed the rest with a
        retry-after sized to the drain rate.  Pure in (occupancy,
        commit_rate, requested)."""
        occupancy = self._occupancy() if self._occupancy is not None else 0
        limit = int(self.watermark * self.capacity)
        headroom = max(0, limit - occupancy)
        accepted = min(max(0, requested), headroom)
        shed = max(0, requested) - accepted
        # credit window: one horizon of drain, floored for cold boots,
        # never past the watermark headroom left AFTER this batch
        window = max(MIN_CREDIT, int(self.commit_rate * self.horizon_s))
        credit = min(max(0, headroom - accepted), window)
        retry_after_ms = 0
        if shed:
            excess = occupancy + requested - limit
            if self.commit_rate > 0:
                retry_after_ms = int(excess / self.commit_rate * 1e3)
            else:
                retry_after_ms = RETRY_MAX_MS
            retry_after_ms = min(RETRY_MAX_MS, max(RETRY_MIN_MS, retry_after_ms))
        self.decisions += 1
        self.accepted_total += accepted
        self.shed_total += shed
        self.last_credit = credit
        if shed:
            self.busy_frames += 1
        j = self.journal
        if j is not None:
            if shed:
                j.record("ingest.shed", dur_ns=shed)
            if self.decisions % CREDIT_SAMPLE_EVERY == 1:
                j.record("ingest.credit", dur_ns=credit)
        return Decision(accepted, shed, credit, retry_after_ms)

    def stats(self) -> dict:
        """Telemetry snapshot section (pull model)."""
        occ = self._occupancy() if self._occupancy is not None else 0
        return {
            "capacity": self.capacity,
            "watermark": self.watermark,
            "occupancy": occ,
            "commit_rate": round(self.commit_rate, 1),
            "accepted_total": self.accepted_total,
            "shed_total": self.shed_total,
            "busy_frames": self.busy_frames,
            "last_credit": self.last_credit,
        }


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default
