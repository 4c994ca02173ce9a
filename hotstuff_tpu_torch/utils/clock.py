"""Time, randomness and connection seams for the network and consensus
layers.

A copy of ``hotstuff_tpu.utils.clock`` without the setters: they exist
for the deterministic simulator, which the port does not have.  Code
calls ``default_clock()`` / ``default_rng()`` / ``default_connector()``
at the point of use and gets real wall time, the module-level ``random``
RNG and ``asyncio.open_connection``.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Any, Awaitable, Callable, Protocol, runtime_checkable

__all__ = [
    "Clock",
    "SYSTEM_CLOCK",
    "default_clock",
    "default_rng",
    "default_connector",
]


@runtime_checkable
class Clock(Protocol):
    """Minimal time surface used by consensus/network code."""

    def time(self) -> float:  # wall clock (unix seconds)
        ...

    def monotonic(self) -> float:  # monotonic seconds
        ...

    def monotonic_ns(self) -> int:  # monotonic nanoseconds
        ...

    async def sleep(self, delay: float) -> None:  # cooperative sleep
        ...


class _SystemClock:
    """Real time."""

    def time(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def monotonic_ns(self) -> int:
        return time.monotonic_ns()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


SYSTEM_CLOCK: Clock = _SystemClock()


def default_clock() -> Clock:
    """The ambient clock: real time."""
    return SYSTEM_CLOCK


def default_rng() -> Any:
    """The ambient RNG: the module-level ``random``, which duck-types as
    a ``random.Random`` instance."""
    return random


def default_connector() -> Callable[..., Awaitable[Any]]:
    """The ambient stream connector: ``asyncio.open_connection``."""
    return asyncio.open_connection
