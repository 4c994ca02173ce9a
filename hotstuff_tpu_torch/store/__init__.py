"""Store: a single-writer store serializing all storage access.

A copy of ``hotstuff_tpu.store``.  ``Store`` opens the C++ engine
(``store/native.py``) by default, as the JAX package does; both engines
speak the same on-disk format.  ``notify_read`` is the blocking-read
primitive the synchronizer's "wait for a missing parent block" is built
on: if the key is missing, the caller's future is parked in an
obligations map and resolved by a later write of that key.
"""

from __future__ import annotations

import asyncio
import os
from collections import deque

from .engine import Engine, WalEngine


def open_engine(
    path: str, prefer_native: bool = True, fsync_mode: int = 0
) -> Engine:
    """Open the engine at ``path``: the C++ engine unless
    ``prefer_native`` is False or ``HOTSTUFF_STORE_NATIVE=0``, else the
    pure-Python WAL.  Both speak the same on-disk format.  fsync_mode:
    0 = flush per put, 1 = fsync per put, 2 = fsync on close.  A native
    library that cannot build raises with the compiler's output (the
    JAX package falls back to the Python engine)."""
    if prefer_native and os.environ.get("HOTSTUFF_STORE_NATIVE") != "0":
        from .native import NativeEngine

        return NativeEngine(path, fsync_mode)
    return WalEngine(path, fsync_mode)


class Store:
    """Single-writer store with the reference's command semantics,
    executed INLINE on the event loop.

    Under asyncio there is exactly one thread, so the loop itself
    already provides the single-writer discipline: operations execute
    synchronously in the caller's coroutine, in call order, which is the
    same total order a command queue would impose.  The ``notify_read``
    obligations map (park a future until a later write of that key) is
    the primitive the synchronizer's missing-parent wait is built on.
    """

    def __init__(self, path: str, engine: Engine | None = None):
        self.engine = engine if engine is not None else open_engine(path)
        self._obligations: dict[bytes, deque[asyncio.Future]] = {}
        self._closed = False

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("Store is closed")

    async def write(self, key: bytes, value: bytes) -> None:
        self._check_open()
        self.engine.put(key, value)
        waiters = self._obligations.pop(key, None)
        if waiters:
            for fut in waiters:
                if not fut.done():
                    fut.set_result(value)

    async def read(self, key: bytes) -> bytes | None:
        self._check_open()
        return self.engine.get(key)

    async def delete(self, key: bytes) -> None:
        """Remove a key (no obligation wake-up — deletes never resolve a
        parked notify_read).  Used by the payload-body budget's eviction
        of uncommitted producer bodies."""
        self._check_open()
        self.engine.delete(key)

    async def notify_read(self, key: bytes) -> bytes:
        """Read that resolves when the key exists (possibly immediately)."""
        self._check_open()
        value = self.engine.get(key)
        if value is not None:
            return value
        fut = asyncio.get_running_loop().create_future()
        self._obligations.setdefault(key, deque()).append(fut)
        return await fut

    def cancel_notify(self, key: bytes) -> None:
        """Cancel and drop every future parked on ``key``.  The
        synchronizer calls this when it gives up on a missing parent:
        waiter tasks cancelled from outside leave their (cancelled)
        futures in the obligations deque, and absent a later write of
        that exact key the entry would pin memory forever."""
        waiters = self._obligations.pop(key, None)
        if waiters:
            for fut in waiters:
                if not fut.done():
                    fut.cancel()

    def close(self) -> None:
        self._closed = True
        for waiters in self._obligations.values():
            for fut in waiters:
                if not fut.done():
                    fut.cancel()
        self._obligations.clear()
        self.engine.close()


__all__ = ["Store", "Engine", "WalEngine", "open_engine"]
