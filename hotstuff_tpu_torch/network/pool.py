"""Bounded per-peer connection pooling shared by the senders.

Reference parity keeps one persistent connection per (sender, peer)
pair forever (simple_sender.rs / reliable_sender.rs) — harmless at the
reference's committee sizes on separate hosts, but a co-located
committee holds BOTH endpoints of every connection in one process:
at 256 nodes the per-round leader-broadcast + vote connections grow
~1k fds/round, monotonically, into the process fd limit (measured —
docs/ROUND5.md, "The 256-node fd wall").

``BoundedPoolMixin`` gives a sender an optional ``max_conns`` bound
enforced by LRU eviction over IDLE connections only (each connection
class defines ``idle`` such that eviction can never drop a queued or
in-flight message), plus a self-terminating sweeper that shrinks
dormant burst pools (a proposer's committee-wide broadcast pool would
otherwise persist until its next leadership, ~committee-size rounds
later).  The host class supplies ``self._connections`` (an insertion-
ordered dict used as the LRU), ``self._max_conns`` and
``self._sweeper``.
"""

from __future__ import annotations

import asyncio

from ..utils.clock import default_clock


class BoundedPoolMixin:
    _connections: dict
    _max_conns: int | None
    _sweeper: asyncio.Task | None

    #: idle connections evicted under the bound (telemetry reads this;
    #: class attr so unevicting senders pay no per-instance slot)
    pool_evictions = 0

    def _lru_hit(self, address) -> object | None:
        """The live connection for ``address`` refreshed to
        most-recently-used, or None if absent/finished."""
        conn = self._connections.get(address)
        if conn is None or conn.task.done():
            return None
        del self._connections[address]
        self._connections[address] = conn
        return conn

    def _admit(self, address, conn) -> None:
        """Register a NEW connection, evicting idle LRU entries to stay
        under the bound and arming the sweeper."""
        if self._max_conns is not None:
            self._evict_idle(self._max_conns - 1)
            self._ensure_sweeper()
        self._connections[address] = conn

    def _evict_idle(self, keep: int) -> None:
        if len(self._connections) <= keep:
            return
        for addr in list(self._connections):
            if len(self._connections) <= keep:
                return
            conn = self._connections[addr]
            if conn.task.done():
                del self._connections[addr]
            elif conn.idle:
                conn.close()
                del self._connections[addr]
                self.pool_evictions += 1

    def _ensure_sweeper(self) -> None:
        """Shrink-to-cap sweeper, armed only while the pool exceeds the
        bound: it exits once back under cap (re-armed on the next
        connection creation), so a big co-located committee does not
        carry hundreds of permanently-waking tasks."""
        if self._sweeper is not None and not self._sweeper.done():
            return

        async def sweep():
            while len(self._connections) > self._max_conns:
                await default_clock().sleep(3.0)
                self._evict_idle(self._max_conns)

        self._sweeper = asyncio.get_running_loop().create_task(sweep())

    def _close_pool(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            self._sweeper = None
        for conn in self._connections.values():
            conn.close()
        self._connections.clear()


def parse_max_conns(raw: str | None) -> int | None:
    """Env-knob parsing: absent/empty/non-positive/garbage = unbounded
    (a negative value must never morph into 'broadcast to nobody')."""
    try:
        v = int(raw or 0)
    except ValueError:
        return None
    return v if v > 0 else None


def abort_writer(writer: asyncio.StreamWriter | None) -> None:
    """Release a socket NOW instead of when the cancelled owner task
    next gets scheduled — on a saturated loop that lag let closing
    sockets pile up against the fd limit.  abort() skips the flush;
    callers only use it on idle connections."""
    if writer is not None:
        try:
            writer.transport.abort()
        except (RuntimeError, AttributeError, OSError):
            pass
