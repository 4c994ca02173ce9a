"""Resettable round timer.

Parity target: reference ``Timer`` (consensus/src/timer.rs:10-34): a
future that completes ``duration`` ms after the last ``reset()``. Here the
deadline is re-checked after every sleep, so a ``reset()`` while a
``wait()`` is outstanding simply extends the sleep instead of requiring
task cancellation — the core's select loop keeps one wait task alive
across resets.
"""

from __future__ import annotations

import asyncio

from ..utils.clock import default_clock


class Timer:
    def __init__(self, duration_ms: int):
        self.duration = duration_ms / 1000.0
        self._deadline: float | None = None
        # observability (free int stores, read by pull gauges / the
        # flight recorder): how often the timer re-armed and when
        self.resets = 0
        self.armed_at_ns = 0

    def set_duration_ms(self, duration_ms: float) -> None:
        """Change the duration used by subsequent resets (the core's
        exponential view-change backoff drives this); the current
        deadline is unaffected."""
        self.duration = duration_ms / 1000.0

    def reset(self) -> None:
        self._deadline = asyncio.get_running_loop().time() + self.duration
        self.resets += 1
        self.armed_at_ns = default_clock().monotonic_ns()

    def expired(self) -> bool:
        """Is the *current* deadline in the past? A ``wait()`` that completed
        before a subsequent ``reset()`` is stale — the reference's tokio
        ``Sleep`` un-readies itself on reset (timer.rs:21-26); callers
        re-check this to get the same semantics."""
        return (
            self._deadline is not None
            and asyncio.get_running_loop().time() >= self._deadline
        )

    async def wait(self) -> None:
        loop = asyncio.get_running_loop()
        if self._deadline is None:
            self._deadline = loop.time() + self.duration
        while True:
            remaining = self._deadline - loop.time()
            if remaining <= 0:
                return
            await default_clock().sleep(remaining)
