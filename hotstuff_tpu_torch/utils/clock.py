"""Time, randomness and connection seams for the network and consensus
layers.

A copy of ``hotstuff_tpu.utils.clock``.  Code calls ``default_clock()``
/ ``default_rng()`` / ``default_connector()`` at the point of use and
gets real wall time, the module-level ``random`` RNG and
``asyncio.open_connection``.  The deterministic simulator
(``hotstuff_tpu_torch/sim``) swaps all three ambient defaults with the
setters before it spawns its in-process committee, so every timer,
jitter draw and socket open in ``consensus/``, ``network/`` and
``faults/`` becomes virtual without a signature changing.

The seam is ambient (a module global, not a context variable): the
simulator runs ONE committee a process on ONE event loop, and nothing
else calls the setters.
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
    "set_default_clock",
    "default_rng",
    "set_default_rng",
    "default_connector",
    "set_default_connector",
]


@runtime_checkable
class Clock(Protocol):
    """Minimal time surface used by consensus/network/fault code."""

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


_clock: Clock = SYSTEM_CLOCK
# The module-level ``random`` module itself duck-types as a Random
# instance (random/uniform/gauss/sample/...), so it is the default of
# the rng seam.
_rng: Any = random
_connector: Callable[..., Awaitable[Any]] = asyncio.open_connection


def default_clock() -> Clock:
    """The ambient clock: real time unless the simulator swapped it."""
    return _clock


def set_default_clock(clock: Clock | None) -> Clock:
    """Install ``clock`` as the ambient default (``None`` resets to the
    system clock).  Returns the previous default so callers can
    save/restore."""
    global _clock
    prev = _clock
    _clock = SYSTEM_CLOCK if clock is None else clock
    return prev


def default_rng() -> Any:
    """The ambient RNG (module ``random`` unless the simulator swapped
    in a seeded ``random.Random``)."""
    return _rng


def set_default_rng(rng: Any | None) -> Any:
    """Install ``rng`` as the ambient default (``None`` resets to the
    module-level ``random``).  Returns the previous default."""
    global _rng
    prev = _rng
    _rng = random if rng is None else rng
    return prev


def default_connector() -> Callable[..., Awaitable[Any]]:
    """The ambient stream connector: ``asyncio.open_connection`` unless
    the simulator swapped in its in-memory transport."""
    return _connector


def set_default_connector(
    connector: Callable[..., Awaitable[Any]] | None,
) -> Callable[..., Awaitable[Any]]:
    """Install ``connector`` as the ambient default (``None`` resets to
    ``asyncio.open_connection``).  Returns the previous default."""
    global _connector
    prev = _connector
    _connector = asyncio.open_connection if connector is None else connector
    return prev
