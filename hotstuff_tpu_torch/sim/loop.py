"""Virtual-time asyncio event loop.

A copy of ``hotstuff_tpu.sim.loop``.

The simulator's clock advances ONLY when the run queue is empty: the
loop is a stock ``SelectorEventLoop`` whose selector never touches an
fd — ``select(timeout)`` simply jumps virtual time forward by
``timeout`` and reports nothing ready.  CPython's ``_run_once`` computes
that timeout as 0 while callbacks are ready and as the distance to the
nearest timer otherwise, so a committee that sleeps 5 virtual seconds
costs zero wall-clock: the whole run is CPU-bound protocol work.

``select(None)`` — no ready callbacks AND no scheduled timers — means
nothing can ever wake the loop again (the sim has no external I/O), so
it raises :class:`SimDeadlock` instead of hanging forever.

Constraint inherited by everything running on this loop: no threads.
``run_in_executor`` / ``call_soon_threadsafe`` wake a real loop through
the self-pipe, which this selector never reports ready.  The simulated
committee honours this (pure-Python WAL engine, inline ed25519
signing, the CPU verifier).
"""

from __future__ import annotations

import asyncio
import selectors

#: Virtual wall-clock origin (unix seconds).  Schedule specs pin
#: ``epoch_unix`` to this, so scenario t=0 == loop time 0.0 in every
#: run regardless of the real date — a precondition for byte-identical
#: journals across runs.
SIM_EPOCH = 1_700_000_000.0


class SimDeadlock(RuntimeError):
    """The virtual loop ran out of ready callbacks AND timers: every
    task is parked on an event nothing will ever set."""


class _VirtualSelector(selectors._BaseSelectorImpl):
    """Selector that advances virtual time instead of polling fds.

    ``_BaseSelectorImpl`` supplies the register/unregister/get_map
    bookkeeping the loop needs for its self-pipe; only ``select`` is
    virtual."""

    def __init__(self, loop: "SimLoop"):
        super().__init__()
        self._loop = loop

    def select(self, timeout=None):
        if timeout is None:
            raise SimDeadlock(
                "virtual loop has no ready callbacks and no timers "
                "(every task is blocked on an event that will never fire)"
            )
        if timeout > 0:
            self._loop._vtime += timeout
        return []


class SimLoop(asyncio.SelectorEventLoop):
    """A ``SelectorEventLoop`` on virtual time (see module docstring)."""

    def __init__(self):
        self._vtime = 0.0
        super().__init__(selector=_VirtualSelector(self))

    def time(self) -> float:
        return self._vtime


class VirtualClock:
    """The :class:`~hotstuff_tpu_torch.utils.clock.Clock` implementation the
    simulator installs as the ambient default: wall time is
    ``SIM_EPOCH`` + virtual seconds, monotonic time is virtual seconds,
    sleeps are virtual-loop timers."""

    def __init__(self, loop: SimLoop):
        self._loop = loop

    def time(self) -> float:
        return SIM_EPOCH + self._loop.time()

    def monotonic(self) -> float:
        return self._loop.time()

    def monotonic_ns(self) -> int:
        return int(self._loop.time() * 1e9)

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(delay)


__all__ = ["SIM_EPOCH", "SimDeadlock", "SimLoop", "VirtualClock"]
