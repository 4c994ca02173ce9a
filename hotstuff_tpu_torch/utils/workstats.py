"""Per-node work accounting for the committee-scaling decomposition.

A copy of ``hotstuff_tpu.utils.workstats``.  A host with fewer cores
than nodes measures host starvation, not protocol cost, in raw
throughput at large committees.  This module separates the two:

- ``CountingVerifier`` wraps a ``VerifierBackend`` and counts calls and
  signatures per call shape (the protocol's dominant CPU cost);
- ``LoopLagProbe`` measures event-loop scheduling lag — the DIRECT
  starvation signal: an idle loop wakes a 50 ms sleep within ~1 ms,
  a core-starved one wakes it late by the amount the host is
  oversubscribed;
- ``WorkStats`` aggregates both plus message counts and logs one
  parseable line periodically (``Work stats: {json}``) — the scaling
  harness scrapes the LAST line per node log.

Enabled by HOTSTUFF_WORK_STATS=1 or by telemetry (node/node.py); zero
cost otherwise.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

log = logging.getLogger(__name__)

LOG_INTERVAL = 5.0
LAG_INTERVAL = 0.05

# The 'Work stats:' scrape contract: every key WorkStats.to_json emits.
# The telemetry snapshot document (telemetry/__init__.py, 'Telemetry
# snapshot:' line) must stay a SUPERSET of these keys at its top level —
# the tests pin both sides to this tuple.
WORKSTATS_KEYS = (
    "elapsed_s",
    "verify_calls",
    "verify_sigs",
    "verify_wall_ms",
    "loop_lag_mean_ms",
    "loop_lag_max_ms",
)


class WorkStats:
    __slots__ = (
        "verify_calls",
        "verify_sigs",
        "verify_wall_s",
        "blocks_processed",
        "lag_samples",
        "lag_total_s",
        "lag_max_s",
        "started",
    )

    def __init__(self):
        self.verify_calls = 0
        self.verify_sigs = 0
        self.verify_wall_s = 0.0
        self.blocks_processed = 0
        self.lag_samples = 0
        self.lag_total_s = 0.0
        self.lag_max_s = 0.0
        self.started = time.monotonic()

    def to_json(self) -> dict:
        elapsed = max(time.monotonic() - self.started, 1e-9)
        return {
            "elapsed_s": round(elapsed, 3),
            "verify_calls": self.verify_calls,
            "verify_sigs": self.verify_sigs,
            "verify_wall_ms": round(self.verify_wall_s * 1e3, 3),
            "loop_lag_mean_ms": round(
                (self.lag_total_s / self.lag_samples * 1e3)
                if self.lag_samples
                else 0.0,
                3,
            ),
            "loop_lag_max_ms": round(self.lag_max_s * 1e3, 3),
        }


class CountingVerifier:
    """Delegating VerifierBackend that accounts calls/signatures/wall
    time into a WorkStats."""

    def __init__(self, inner, stats: WorkStats):
        self.inner = inner
        self.stats = stats
        self.name = getattr(inner, "name", "counted")

    def _timed(self, n_sigs: int, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stats.verify_wall_s += time.perf_counter() - t0
        self.stats.verify_calls += 1
        self.stats.verify_sigs += n_sigs
        return out

    def verify_one(self, digest, pk, sig) -> bool:
        return self._timed(1, self.inner.verify_one, digest, pk, sig)

    def verify_shared_msg(self, digest, votes) -> bool:
        return self._timed(
            len(votes), self.inner.verify_shared_msg, digest, votes
        )

    def verify_many(self, digests, pks, sigs, aggregate_ok: bool = False):
        def call(d, p, s):
            return self.inner.verify_many(d, p, s, aggregate_ok=aggregate_ok)

        return self._timed(len(digests), call, digests, pks, sigs)

    def __getattr__(self, item):
        # precompute/warmup/etc. pass through untimed
        return getattr(self.inner, item)


async def run_probe(stats: WorkStats, logger=None) -> None:
    """Periodic loop-lag sampling + stats logging; cancelled at node
    shutdown.  NOTE: the 'Work stats:' line is scraped by the scaling
    harness (benchmark/scaling.py)."""
    logger = logger or log
    loop = asyncio.get_running_loop()
    next_log = loop.time() + LOG_INTERVAL
    while True:
        t0 = loop.time()
        await asyncio.sleep(LAG_INTERVAL)
        lag = max(loop.time() - t0 - LAG_INTERVAL, 0.0)
        stats.lag_samples += 1
        stats.lag_total_s += lag
        stats.lag_max_s = max(stats.lag_max_s, lag)
        if loop.time() >= next_log:
            next_log = loop.time() + LOG_INTERVAL
            logger.info("Work stats: %s", json.dumps(stats.to_json()))
