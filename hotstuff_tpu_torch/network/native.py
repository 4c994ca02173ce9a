"""ctypes bridge to the native C++ transport reactor (native/transport.cpp).

A copy of ``hotstuff_tpu.network.native``; the chaos plane's seams
(``fault_plane=``, ``faults/plane.py``), flow accounting (``flows=``,
``telemetry/flows.py``) and the simple sender's ``lucky_broadcast`` are
the reference's, and, as there, no link of the native transport is
WAN-delayed.  The reference's network layer is
native (tokio TCP); this is its native equivalent — an epoll reactor
thread owning every socket, bridged into asyncio through a notify pipe:
the loop registers the pipe fd with ``add_reader`` and drains the
reactor's event queue without ever blocking.  API mirrors of the
asyncio classes:

- ``NativeReceiver(host, port, handler, fault_plane=, flows=)`` — like
  ``receiver.Receiver``:
  every inbound frame goes through ``dispatch_ingest`` to
  ``handler.dispatch(writer, bytes)``, where the writer replies (ACKs)
  on the same connection;
- ``NativeSimpleSender(fault_plane=, flows=)`` — like ``simple_sender.SimpleSender``:
  persistent best-effort per-peer connections, frames dropped while the
  peer is down, reconnect attempted on the next send; peer ACK frames
  are read and discarded;
- ``NativeReliableSender(fault_plane=, flows=)`` — like ``reliable_sender.ReliableSender``:
  per-frame ACK futures, retransmission after a reconnect.

The library is the port's own build of ``native/transport.cpp`` and
``native/wave_pack.cpp`` (``hotstuff_tpu_torch/_native_build.py``),
made on first use; a
build or load failure raises.  The reactor thread is stopped at
interpreter exit.
"""

from __future__ import annotations

import asyncio
import atexit
import ctypes
import logging
import random
from collections import deque

from .. import _native_build
from ..faults.plane import BARRIER_POLL_S, corrupt_frame
from .receiver import dispatch_ingest

log = logging.getLogger(__name__)

_MAX_FRAME = 64 * 1024 * 1024

KIND_FRAME_ACCEPTED = 1
KIND_FRAME_PEER = 2
KIND_ACCEPTED_CLOSED = 3
KIND_PEER_CLOSED = 4

Address = tuple[str, int]


class Reactor:
    """One reactor thread per process, shared by every native receiver
    and sender on the running asyncio loop."""

    _instance: "Reactor | None" = None

    def __init__(self):
        self.lib = _native_build.load("transport")
        self.handle = self.lib.ht_start()
        if not self.handle:
            raise RuntimeError("ht_start failed")
        self.notify_fd = self.lib.ht_notify_fd(self.handle)
        self._buf = ctypes.create_string_buffer(1 << 20)  # grown on demand
        # listener id -> router callback (one per NativeReceiver; many
        # receivers share this process-wide reactor, e.g. a co-located
        # committee runs on it)
        self._routers: dict[int, object] = {}
        # accepted conn id -> listener id (cached ht_conn_listener)
        self._conn_listener: dict[int, int] = {}
        # outbound peer id -> handler(kind, payload) — used by the
        # reliable sender for ACK pairing; absent = ACKs discarded
        # (best-effort senders, reference simple_sender.rs:120-131)
        self._peer_handlers: dict[int, object] = {}
        self._reader_loop: asyncio.AbstractEventLoop | None = None
        # a live reactor thread must never hold up interpreter exit
        atexit.register(self.close)

    @classmethod
    def shared(cls) -> "Reactor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def counters(self) -> dict:
        """Cumulative reactor wire counters (bytes and frames each way,
        length prefixes included in the bytes)."""
        out = (ctypes.c_ulonglong * 4)()
        self.lib.ht_counters(self.handle, out)
        return {
            "tx_bytes": int(out[0]),
            "tx_frames": int(out[1]),
            "rx_bytes": int(out[2]),
            "rx_frames": int(out[3]),
        }

    def ensure_reader(self) -> None:
        """Register the notify-fd reader with the RUNNING loop.  The
        reactor is a process singleton but loops come and go (each
        asyncio.run creates one), so registration is tracked per loop —
        a stale registration died with its loop."""
        loop = asyncio.get_running_loop()
        if self._reader_loop is not loop or loop.is_closed():
            loop.add_reader(self.notify_fd, self._drain)
            self._reader_loop = loop
            self._drain()  # deliver anything queued while unregistered

    def _drain(self) -> None:
        src = ctypes.c_long()
        kind = ctypes.c_int()
        while self.handle:
            n = self.lib.ht_next(
                self.handle, ctypes.byref(src), ctypes.byref(kind),
                self._buf, len(self._buf),
            )
            if n == -1:
                return
            if n == -2:
                self._buf = ctypes.create_string_buffer(
                    min(len(self._buf) * 4, _MAX_FRAME + 4)
                )
                continue
            # copy the n bytes of this event only: ``self._buf.raw[:n]``
            # (the JAX package's) copies the whole 1 MiB buffer first
            payload = ctypes.string_at(self._buf, n)
            k = kind.value
            if k in (KIND_FRAME_ACCEPTED, KIND_ACCEPTED_CLOSED):
                conn = src.value
                lid = self._conn_listener.get(conn)
                if lid is None:
                    lid = self.lib.ht_conn_listener(self.handle, conn)
                    self._conn_listener[conn] = lid
                router = self._routers.get(lid)
                if router is not None:
                    router(conn, k, payload)
                if k == KIND_ACCEPTED_CLOSED:
                    self._conn_listener.pop(conn, None)
            elif k in (KIND_FRAME_PEER, KIND_PEER_CLOSED):
                handler = self._peer_handlers.get(src.value)
                if handler is not None:
                    handler(k, payload)

    def close(self) -> None:
        """Stop the reactor thread and close every socket it owns."""
        if self._reader_loop is not None and not self._reader_loop.is_closed():
            try:
                self._reader_loop.remove_reader(self.notify_fd)
            except RuntimeError:
                pass
        self._reader_loop = None
        if self.handle:
            self.lib.ht_stop(self.handle)
            self.handle = None
        atexit.unregister(self.close)
        if Reactor._instance is self:
            Reactor._instance = None


class NativeWriter:
    """Reply channel handed to MessageHandler.dispatch."""

    def __init__(self, reactor: Reactor, conn_id: int, flows=None):
        self._reactor = reactor
        self._conn = conn_id
        self._flows = flows

    async def send(self, payload: bytes) -> None:
        # a refused reply (outbox full -> connection closed) never hits
        # the wire, as a reply to a vanished asyncio peer; replies leave
        # on the accepted connection and are charged only when accepted
        if self._reactor.handle:
            rc = self._reactor.lib.ht_reply(
                self._reactor.handle, self._conn, payload, len(payload)
            )
            if rc == 0 and self._flows is not None:
                self._flows.tx(self.peer, payload)

    @property
    def peer(self):
        return ("native", self._conn)


class NativeReceiver:
    """Native drop-in for ``receiver.Receiver``.

    Frames are dispatched by ONE persistent worker task per accepted
    connection consuming an ordered queue — the same serial-per-
    connection discipline as the asyncio Receiver's runner loop (a task
    per frame would churn the loop under bursts and allow reordering).

    Flow control: the asyncio receiver gets backpressure for free (its
    reader task blocks on a full handler queue, closing the TCP
    window); here the reactor reads frames regardless, so the dispatch
    queue is watermarked — past HIGH_WATER the connection's reads are
    PAUSED in the reactor (``ht_set_read_paused``) and resumed at
    LOW_WATER.  Without this an overloaded node buffers everything in
    unbounded queues.

    ``fault_plane``: the inbound cut of an ``isolate`` window, as on
    ``receiver.Receiver``."""

    HIGH_WATER = 256
    LOW_WATER = 64

    def __init__(
        self, host: str, port: int, handler, fault_plane=None, flows=None
    ):
        self.host = host
        self.port = port
        self.handler = handler
        self._faults = fault_plane
        self._flows = flows
        self.reactor = Reactor.shared()
        self._listener = -1
        self._queues: dict[int, asyncio.Queue] = {}
        self._workers: dict[int, asyncio.Task] = {}
        self._paused: set[int] = set()

    async def spawn(self) -> None:
        from ..crypto.async_service import zero_copy_ingest

        # the first receiver creates the ingest plane (raises at boot
        # when it cannot start, see zero_copy_ingest)
        zero_copy_ingest()
        self.reactor.ensure_reader()
        host = _resolve(self.host) if self.host != "0.0.0.0" else self.host
        if host is not None:
            self._listener = self.reactor.lib.ht_listen(
                self.reactor.handle, host.encode(), self.port
            )
        if self._listener < 0:
            from .errors import ListenError

            raise ListenError((self.host, self.port), "native listen failed")
        self.reactor._routers[self._listener] = self._route
        log.debug("Native listener on %s:%d", host, self.port)

    def _route(self, conn_id: int, kind: int, payload: bytes) -> None:
        if kind == KIND_ACCEPTED_CLOSED:
            q = self._queues.pop(conn_id, None)
            self._workers.pop(conn_id, None)
            self._paused.discard(conn_id)
            if q is not None:
                q.put_nowait(None)  # drain sentinel; the worker exits
            return
        if kind != KIND_FRAME_ACCEPTED:
            return
        # charge receive flows at delivery from the reactor (accepted
        # conns carry no committee identity: attributed to "native")
        if self._flows is not None:
            self._flows.rx(("native", conn_id), payload)
        q = self._queues.get(conn_id)
        if q is None:
            q = asyncio.Queue()
            self._queues[conn_id] = q
            self._workers[conn_id] = asyncio.get_running_loop().create_task(
                self._worker(conn_id, q), name=f"native-conn-{conn_id}"
            )
        q.put_nowait(payload)
        if q.qsize() >= self.HIGH_WATER and conn_id not in self._paused:
            self._paused.add(conn_id)
            self.reactor.lib.ht_set_read_paused(
                self.reactor.handle, conn_id, 1
            )

    async def _worker(self, conn_id: int, q: asyncio.Queue) -> None:
        writer = NativeWriter(self.reactor, conn_id, flows=self._flows)
        while True:
            payload = await q.get()
            if payload is None:
                return
            if self._faults is not None and self._faults.inbound_cut():
                payload = b""  # isolate window: swallow the frame unACKed
            try:
                if payload:
                    await dispatch_ingest(self.handler, writer, payload)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a handler bug must not
                # leave the connection read-paused forever (a silent,
                # reconnect-less stall): close it like the asyncio
                # Receiver does when dispatch raises, so the peer's
                # reconnect logic recovers.  The close event cleans up
                # _queues/_paused via _route.
                log.exception(
                    "handler.dispatch failed on native conn %d; closing",
                    conn_id,
                )
                if self.reactor.handle:
                    self.reactor.lib.ht_close_conn(
                        self.reactor.handle, conn_id
                    )
                return
            if (
                conn_id in self._paused
                and q.qsize() <= self.LOW_WATER
                and self.reactor.handle
            ):
                self._paused.discard(conn_id)
                self.reactor.lib.ht_set_read_paused(
                    self.reactor.handle, conn_id, 0
                )

    @property
    def connections(self) -> int:
        """Live accepted connections with a frame delivered."""
        return len(self._queues)

    async def shutdown(self) -> None:
        for t in list(self._workers.values()):
            t.cancel()
        if self.reactor.handle:
            for conn_id in self._queues:
                self.reactor.lib.ht_close_conn(self.reactor.handle, conn_id)
        self._workers.clear()
        self._queues.clear()
        self._paused.clear()
        self.reactor._routers.pop(self._listener, None)
        if self._listener >= 0 and self.reactor.handle:
            self.reactor.lib.ht_close_listener(
                self.reactor.handle, self._listener
            )
        self._listener = -1


_RESOLVE_CACHE: dict[str, tuple[str | None, float]] = {}
_RESOLVE_NEG_TTL = 30.0  # retry failed lookups after this many seconds


def _resolve(host: str) -> str | None:
    """Host-side name resolution — the C++ reactor takes dotted quads
    only (inet_pton), while the asyncio transport resolves names.
    Returns None on failure: callers log and DROP (matching the asyncio
    senders, which catch OSError in their connection tasks — a DNS blip
    must not crash a consensus actor).  Lookups are cached — successes
    forever, failures for a short TTL — so the blocking gethostbyname
    cannot run on the event loop for every send to a dead name."""
    import ipaddress
    import socket
    import time

    if host == "localhost":
        return "127.0.0.1"
    try:
        ipaddress.ip_address(host)
        return host
    except ValueError:
        pass
    hit = _RESOLVE_CACHE.get(host)
    # lint: allow(clock-discipline) -- DNS-cache TTL on the native
    # transport path; the simulator only drives transport="sim"
    now = time.monotonic()
    if hit is not None and (hit[0] is not None or now < hit[1]):
        return hit[0]
    try:
        resolved = socket.gethostbyname(host)
        _RESOLVE_CACHE[host] = (resolved, 0.0)
    except OSError as e:
        log.warning("cannot resolve %s: %s", host, e)
        _RESOLVE_CACHE[host] = (None, now + _RESOLVE_NEG_TTL)
        return None
    return resolved


class NativeSimpleSender:
    """Native drop-in for ``simple_sender.SimpleSender``: best-effort,
    frames to a peer that is down are dropped and the next send
    reconnects.  ``flows`` is charged for each frame the reactor
    accepts (``ht_send`` returned 0) and once per ``send``/``broadcast``
    call on the logical ledger.

    ``fault_plane`` (chaos plane, faults/plane.py): best-effort links
    support the full fault matrix — drop skips the send, delay defers
    the ``ht_send`` via ``call_later`` (later undelayed frames may
    overtake it: reordering is fair game on a lossy best-effort link),
    corrupt mangles the bytes, duplicate hands the frame over twice."""

    def __init__(self, fault_plane=None, flows=None):
        self.reactor = Reactor.shared()
        self._fault_plane = fault_plane
        self._flows = flows
        self._links: dict[Address, object] = {}
        self._peers: dict[Address, int] = {}

    def _link(self, address: Address):
        if self._fault_plane is None:
            return None
        if address not in self._links:
            self._links[address] = self._fault_plane.link(address)
        return self._links[address]

    def _peer(self, address: Address) -> int | None:
        peer = self._peers.get(address)
        if peer is None:
            host = _resolve(address[0])
            if host is None:
                return None  # unresolvable: drop (best-effort semantics)
            peer = self.reactor.lib.ht_connect(
                self.reactor.handle, host.encode(), address[1]
            )
            self._peers[address] = peer
        return peer

    async def send(self, address: Address, payload: bytes) -> None:
        if self._flows is not None:
            self._flows.logical(payload)
        await self._dispatch(address, payload)

    async def _dispatch(self, address: Address, payload: bytes) -> None:
        if not self.reactor.handle:
            return  # the reactor stopped (interpreter exit)
        self.reactor.ensure_reader()
        peer = self._peer(address)
        if peer is None:
            return
        faults = self._link(address)
        if faults is not None:
            decision = faults.decide()
            if decision.drop:
                return
            if decision.corrupt:
                payload = corrupt_frame(payload)
            if decision.delay_s:
                asyncio.get_running_loop().call_later(
                    decision.delay_s, self._send_now, address, peer,
                    payload, decision.duplicate,
                )
                return
            if decision.duplicate:
                self._send_now(address, peer, payload, True)
                return
        rc = self.reactor.lib.ht_send(
            self.reactor.handle, peer, payload, len(payload)
        )
        if rc == 0 and self._flows is not None:
            self._flows.tx(address, payload)

    def _send_now(
        self, address: Address, peer: int, payload: bytes, duplicate: bool
    ) -> None:
        if not self.reactor.handle:
            return  # reactor stopped while the frame sat in its delay
        rc = self.reactor.lib.ht_send(
            self.reactor.handle, peer, payload, len(payload)
        )
        if rc == 0 and self._flows is not None:
            self._flows.tx(address, payload)
        if duplicate:
            rc = self.reactor.lib.ht_send(
                self.reactor.handle, peer, payload, len(payload)
            )
            if rc == 0 and self._flows is not None:
                self._flows.tx(address, payload)

    async def broadcast(self, addresses: list[Address], payload: bytes) -> None:
        # ONE logical charge per broadcast call regardless of fan-out
        # (wire/logical per class == amplification factor)
        if self._flows is not None and addresses:
            self._flows.logical(payload)
        for address in addresses:
            await self._dispatch(address, payload)

    async def lucky_broadcast(
        self, addresses: list[Address], payload: bytes, nodes: int
    ) -> None:
        """Send to ``nodes`` randomly-picked peers (the module-level
        ``random``, as the reference's native sender draws them)."""
        # lint: allow(clock-discipline) -- native-transport-only helper;
        # the sim's lucky_broadcast runs the asyncio sender via the seam
        picks = random.sample(addresses, min(nodes, len(addresses)))
        if self._flows is not None and picks:
            self._flows.logical(payload)
        for address in picks:
            await self._dispatch(address, payload)

    def close(self) -> None:
        if self.reactor.handle:
            for pid in self._peers.values():
                self.reactor.lib.ht_close_conn(self.reactor.handle, pid)
        self._peers.clear()


class NativeReliableSender:
    """Native drop-in for ``reliable_sender.ReliableSender``.

    Semantics (reference reliable_sender.rs:25-248): every ``send``
    returns a future resolved with the peer's ACK payload for that
    message; ACKs pair FIFO with frames the peer actually received; on
    connection failure every un-ACKed, un-cancelled message is
    retransmitted once the reactor reconnects, with exponential backoff
    (200 ms doubling, 60 s cap, full jitter past the first retry).  The
    C++ layer transmits and reconnects; the pairing/retransmit state
    machine lives here.

    Pairing correctness: per peer, ``queue`` holds ``[payload, future]``
    in send order and ``sent`` counts its prefix handed to the reactor on
    the CURRENT connection.  ACKs pop the front (the oldest sent frame).
    A reactor-outbox-full refusal leaves the frame unsent, and every
    later frame queues behind it, so transmission order always equals
    queue order.  On disconnect ``sent`` resets to zero: stale ACKs died
    with the socket, and the whole queue is retransmitted (at least once
    until ACKed, like the reference).

    ``flows``: each frame handed to the reactor is charged on the wire
    ledger when ``ht_send`` accepts it — a second hand-over after a
    disconnect as a retransmit — and each ``send``/``broadcast`` call
    once on the logical ledger.

    ``fault_plane`` (chaos plane, faults/plane.py): the FIFO pairing
    allows only order-preserving faults here — a barrier (hard
    partition window) or a drawn drop defers the flush exactly like an
    outbox-full refusal (head-of-line hold, frames flow when the window
    closes / on the next attempt); delay/corrupt/duplicate are skipped
    on native reliable links."""

    RETRY_DELAY_S = 0.2
    RETRY_CAP_S = 60.0

    def __init__(self, fault_plane=None, flows=None):
        self.reactor = Reactor.shared()
        self._fault_plane = fault_plane
        self._flows = flows
        self._links: dict[int, object] = {}  # pid -> LinkFaults | None
        self._peers: dict[Address, int] = {}
        self._addrs: dict[int, Address] = {}  # pid -> address (flow peer)
        # pid -> deque[[payload, fut, transmitted]]: the third slot
        # flips once the frame first reaches the reactor, so a
        # post-disconnect re-send is charged as a RETRANSMIT at the
        # actual re-send time (sent resets to 0 on KIND_PEER_CLOSED)
        self._queue: dict[int, deque] = {}
        self._sent: dict[int, int] = {}  # pid -> sent prefix length
        self._delay: dict[int, float] = {}
        self._retry_handle: dict[int, object] = {}
        # futures returned for unresolvable peers: never transmitted,
        # but close() must still cancel them so no caller hangs
        self._orphans: list[asyncio.Future] = []

    def _peer(self, address: Address) -> int | None:
        pid = self._peers.get(address)
        if pid is None:
            host = _resolve(address[0])
            if host is None:
                return None  # unresolvable: the future stays pending
            pid = self.reactor.lib.ht_connect(
                self.reactor.handle, host.encode(), address[1]
            )
            self._peers[address] = pid
            self._addrs[pid] = address
            self._queue[pid] = deque()
            self._sent[pid] = 0
            if self._fault_plane is not None:
                self._links[pid] = self._fault_plane.link(address)
            self.reactor._peer_handlers[pid] = (
                lambda kind, payload, pid=pid: self._on_peer_event(
                    pid, kind, payload
                )
            )
        return pid

    async def send(self, address: Address, payload: bytes) -> asyncio.Future:
        if self._flows is not None:
            self._flows.logical(payload)
        return await self._enqueue(address, payload)

    async def _enqueue(self, address: Address, payload: bytes) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        pid = None
        if self.reactor.handle:  # else the reactor stopped (exit)
            self.reactor.ensure_reader()
            pid = self._peer(address)
        if pid is None:
            # like a peer that never comes up: the caller's quorum wait
            # proceeds on the other handles (it cancels this one); the
            # orphan list lets close() cancel it if nobody does
            self._orphans.append(fut)
            return fut
        self._queue[pid].append([payload, fut, False])
        self._flush(pid)
        return fut

    async def broadcast(
        self, addresses: list[Address], payload: bytes
    ) -> list[asyncio.Future]:
        # ONE logical charge per broadcast call regardless of fan-out
        if self._flows is not None and addresses:
            self._flows.logical(payload)
        return [await self._enqueue(a, payload) for a in addresses]

    def _flush(self, pid: int) -> None:
        """Hand the unsent queue suffix to the reactor, in order,
        stopping at the first refusal (outbox full) — a short retry
        keeps order without busy-waiting."""
        q = self._queue[pid]
        faults = self._links.get(pid)
        while self._sent[pid] < len(q):
            entry = q[self._sent[pid]]
            payload, fut = entry[0], entry[1]
            if fut.cancelled():
                # only a frame already sent occupies an ACK slot;
                # unsent cancelled frames can simply be dropped
                del q[self._sent[pid]]
                continue
            if faults is not None and (faults.barrier() or faults.decide().drop):
                # hold the head of the line like an outbox-full refusal:
                # order and ACK pairing survive, frames flow on retry
                if self._retry_handle.get(pid) is None:
                    self._retry_handle[pid] = (
                        asyncio.get_running_loop().call_later(
                            BARRIER_POLL_S, self._retry_flush, pid
                        )
                    )
                return
            rc = self.reactor.lib.ht_send(
                self.reactor.handle, pid, payload, len(payload)
            )
            if rc != 0:
                if self._retry_handle.get(pid) is None:
                    self._retry_handle[pid] = (
                        asyncio.get_running_loop().call_later(
                            0.05, self._retry_flush, pid
                        )
                    )
                return
            if self._flows is not None:
                # a frame handed to the reactor a second time (sent
                # reset by a disconnect) is a retransmit, charged NOW
                self._flows.tx(
                    self._addrs.get(pid, ("native", pid)),
                    payload,
                    retx=entry[2],
                )
            entry[2] = True
            self._sent[pid] += 1

    def _retry_flush(self, pid: int) -> None:
        self._retry_handle.pop(pid, None)
        if pid in self._queue and self.reactor.handle:
            self._flush(pid)

    def _on_peer_event(self, pid: int, kind: int, payload: bytes) -> None:
        q = self._queue.get(pid)
        if q is None:
            return
        if kind == KIND_FRAME_PEER:
            self._delay[pid] = self.RETRY_DELAY_S  # traffic: reset backoff
            # pop the oldest SENT frame (a cancelled future still took
            # an ACK slot on the wire — the peer ACKed the frame)
            if self._sent[pid] > 0:
                fut = q.popleft()[1]
                self._sent[pid] -= 1
                if not fut.cancelled():
                    fut.set_result(payload)
        elif kind == KIND_PEER_CLOSED:
            # connection died: nothing is in flight any more; retransmit
            # the whole queue after a backoff (the reactor reconnects on
            # the next ht_send)
            self._sent[pid] = 0
            delay = self._delay.get(pid, self.RETRY_DELAY_S)
            self._delay[pid] = min(delay * 2, self.RETRY_CAP_S)
            if delay > self.RETRY_DELAY_S:
                # full jitter past the first retry, as the asyncio
                # ReliableSender: spread post-heal reconnects
                # lint: allow(clock-discipline) -- reconnect jitter on
                # the native reactor; never runs under the simulator
                delay = random.uniform(0, delay)
            if self._retry_handle.get(pid) is None:
                self._retry_handle[pid] = asyncio.get_running_loop().call_later(
                    delay, self._retry_flush, pid
                )

    def close(self) -> None:
        for pid in self._peers.values():
            self.reactor._peer_handlers.pop(pid, None)
            handle = self._retry_handle.pop(pid, None)
            if handle is not None:
                handle.cancel()
            if self.reactor.handle:
                self.reactor.lib.ht_close_conn(self.reactor.handle, pid)
        for q in self._queue.values():
            for entry in q:
                if not entry[1].done():
                    entry[1].cancel()  # no caller may hang on a dead sender
        for fut in self._orphans:
            if not fut.done():
                fut.cancel()
        self._orphans.clear()
        self._peers.clear()
        self._addrs.clear()
        self._queue.clear()
        self._sent.clear()


__all__ = [
    "NativeReceiver",
    "NativeReliableSender",
    "NativeSimpleSender",
    "NativeWriter",
    "Reactor",
]
