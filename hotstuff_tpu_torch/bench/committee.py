"""Co-located committee driver: n consensus stacks in one event loop,
fed producer frames over TCP, all verifying through one shared verifier.

The port's counterpart of ``hotstuff_tpu/node/main.py`` ``_run_many``
trimmed to the consensus stack (the ``Node`` composition root, the node
CLI and its benchmark client are not ported yet): every node is a
``Consensus.spawn`` stack on localhost, as the JAX package's end-to-end
tests drive them, and the load follows ``node/client.py``'s open loop —
``rate`` producer frames a second, each ``encode_producer(digest,
body)`` with a ``size``-byte body, each to ONE node in round-robin
order, through the receiver's producer path, ``PayloadBodies`` and
admission.

    from hotstuff_tpu_torch.bench.committee import run_committee
    result = run_committee(nodes=64, rate=1000, duration=20)

Listener ports come from the OS: each node's socket is bound to port 0
first, the committee is built from the numbers the OS assigned, and
each socket is closed just before its node's receiver binds the port.
Keys and payload bodies are made from ``seed``.
"""

from __future__ import annotations

import asyncio
import gc
import logging
import os
import random
import socket
import statistics
import tempfile
import time

from ..consensus import Committee, Consensus, Parameters
from ..consensus.wire import encode_producer
from ..crypto import Digest, SignatureService, generate_keypair
from ..crypto.async_service import AsyncVerifyService
from ..network.framing import read_frame, set_nodelay, write_frame
from ..node import make_verifier
from ..store import Store

log = logging.getLogger(__name__)

#: client open loop (node/client.py): bursts a second, and the deficit
#: catch-up cap in nominal bursts — beyond it a stalled client's backlog
#: is forgiven rather than sent as one giant burst
PRECISION = 20
BURST_INTERVAL = 1.0 / PRECISION
CATCHUP_BURSTS = 8
#: event-loop heartbeat period (the storm benchmark's probe)
HEARTBEAT_S = 0.005


def reserve_ports(n: int, host: str = "127.0.0.1") -> list[socket.socket]:
    """``n`` sockets bound to ports the OS assigns on ``host``, not
    listening.  Each port stays reserved until its socket is closed,
    which the caller does just before binding a listener there (or hands
    the socket to ``asyncio.start_server(sock=...)``).  OS-assigned ports
    lie in the ephemeral range, apart from any fixed port range."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            # as asyncio's listeners set it: the port can be listened on
            # again right after a server on it closes
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
    except OSError:
        for s in socks:
            s.close()
        raise
    return socks


def _raise_fd_limit(target: int) -> None:
    """Best-effort RLIMIT_NOFILE raise to ``target`` (a copy of
    ``node/main.py`` ``_raise_fd_limit``): never lowers the hard cap;
    keeps the current limit when it is enough or the raise is denied."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft >= target:
            return
        # RLIM_INFINITY is -1 on Linux: touch the hard cap only when it
        # is finite and below the target
        if hard != resource.RLIM_INFINITY and hard < target:
            new_hard = target
        else:
            new_hard = hard
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (target, new_hard))
        except (ValueError, OSError):
            # can't raise the hard cap: take everything the soft cap allows
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ValueError, OSError, ImportError):
        pass


def _peer_conn_cap(n: int) -> str | None:
    """``HOTSTUFF_MAX_PEER_CONNS`` for ``n`` co-located nodes when the fd
    limit cannot cover the quadratic worst case (2 fds a connection, one
    connection per sender and peer), as ``node/main.py`` sets it; None
    when it can."""
    import resource

    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if n <= 1 or soft >= 2 * n * n + 10_000:
        return None
    budget_conns = max(1_000, (soft - 4_000) // 2)
    return str(max(4, budget_conns // (4 * n)))


def _freeze_boot_objects():
    """Move boot-time immortals (committee state, caches, the torch
    runtime) out of the collector's generations, and stretch gen2 with a
    scheduled sweep (the logic of ``node/main.py``
    ``_freeze_boot_objects``): full collections re-scan every live
    object and were measured at 30-55 ms a pause on a one-core host.
    ``HOTSTUFF_GC_GEN2_STRETCH=0`` keeps the default thresholds;
    ``HOTSTUFF_GC_GEN2_PERIOD`` sets the sweep period (s).  Returns a
    callable that undoes all of it."""
    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()
    sweep = None
    stretch = os.environ.get("HOTSTUFF_GC_GEN2_STRETCH", "1").strip().lower()
    if stretch not in ("", "0", "false", "no", "off"):
        g0, g1, _ = thresholds
        gc.set_threshold(g0, g1, 500)
        period = float(os.environ.get("HOTSTUFF_GC_GEN2_PERIOD", "300") or 300)
        if period > 0:

            async def _gen2_sweep() -> None:
                while True:
                    await asyncio.sleep(period)
                    t0 = time.perf_counter()
                    freed = gc.collect(2)
                    log.debug(
                        "scheduled gen2 sweep: %d collected in %.1f ms",
                        freed,
                        (time.perf_counter() - t0) * 1e3,
                    )

            sweep = asyncio.ensure_future(_gen2_sweep())

    def undo() -> None:
        if sweep is not None:
            sweep.cancel()
        gc.set_threshold(*thresholds)
        gc.unfreeze()

    return undo


class _ProducerConn:
    """One framed client connection to a node; its ACK frames are read
    and dropped.  A node that stops reading is marked dead, as
    ``node/client.py`` does, so one stalled node cannot stall the load
    on the others."""

    def __init__(self, reader, writer):
        self.writer = writer
        self.alive = True
        self._sink = asyncio.ensure_future(self._drain_acks(reader))

    def send_frame(self, frame: bytes) -> None:
        try:
            write_frame(self.writer, frame)
        except (ConnectionError, OSError):
            self.close()

    async def drain(self, timeout: float = 1.0) -> None:
        if not self.alive:
            return
        try:
            await asyncio.wait_for(self.writer.drain(), timeout)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            log.warning("producer connection to %s stalled; dropping it",
                        self.writer.get_extra_info("peername"))
            self.close()

    @staticmethod
    async def _drain_acks(reader) -> None:
        try:
            while True:
                await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass

    def close(self) -> None:
        # abort, not close: a graceful close would wait to flush frames
        # the node may never read, while the node's ACKs back to this
        # (no longer reading) socket fill its own buffer — both ends in
        # one process, each waiting on the other, and the node's
        # receiver shutdown would wait on that connection forever
        self.alive = False
        self._sink.cancel()
        self.writer.transport.abort()


async def _send_load(conns, rate, duration, size, rng, sent_at) -> int:
    """The open loop of ``node/client.py`` ``run_client`` with one home
    a payload, round-robin over the live connections: returns the
    payloads sent."""
    loop = asyncio.get_running_loop()
    burst = max(1, rate // PRECISION)
    start = loop.time()
    sent = 0
    forgiven = 0
    while loop.time() - start < duration:
        slot_start = loop.time()
        # the slot's send count derives from the wall clock, so a slot
        # that overran leaves a deficit the following slots repay
        target = int((slot_start - start) * rate) + burst - sent - forgiven
        live = [c for c in conns if c.alive]
        if not live:
            raise RuntimeError("every node stopped reading producer frames")
        if target > burst * CATCHUP_BURSTS:
            forgiven += target - burst * CATCHUP_BURSTS
            target = burst * CATCHUP_BURSTS
        for _ in range(max(0, target)):
            if size > 0:
                # the counter makes every body unique
                body = sent.to_bytes(8, "big") + rng.randbytes(max(0, size - 8))
                digest = Digest.of(body)
            else:
                body = b""
                digest = Digest(rng.randbytes(Digest.SIZE))
            sent_at[digest] = loop.time()
            live[sent % len(live)].send_frame(encode_producer(digest, body))
            sent += 1
        for c in live:
            await c.drain()
        elapsed = loop.time() - slot_start
        if elapsed < BURST_INTERVAL:
            await asyncio.sleep(BURST_INTERVAL - elapsed)
    return sent


async def _drained(service, limit_s: float = 10.0) -> None:
    """Let every in-flight device wave land before the service closes,
    so no slot thread is left mid-launch."""
    t_end = time.perf_counter() + limit_s
    while service._inflight and time.perf_counter() < t_end:
        await asyncio.sleep(0.001)


async def _committee(
    nodes, rate, duration, size, verifier, device, timeout_delay, seed
) -> dict:
    loop = asyncio.get_running_loop()
    t_boot = time.perf_counter()
    # File-descriptor headroom: n co-located nodes keep one persistent
    # connection per (sender, peer) pair with BOTH endpoints in this
    # process, so a committee-wide broadcast can open ~2*n^2 sockets.
    _raise_fd_limit(2 * nodes * nodes + 20_000)
    cap = _peer_conn_cap(nodes)
    set_cap = cap is not None and "HOTSTUFF_MAX_PEER_CONNS" not in os.environ
    tmp = tempfile.TemporaryDirectory(prefix="committee-")
    socks: list[socket.socket] = []
    service = None
    stacks, stores, queues = [], [], []
    tasks: list[asyncio.Task] = []
    conns: list[_ProducerConn] = []
    undo_gc = None
    result: dict = {}
    try:
        if set_cap:
            os.environ["HOTSTUFF_MAX_PEER_CONNS"] = cap
            log.info("fd limit too low for %d nodes: pools capped at %s", nodes, cap)
        seed_bytes = seed.to_bytes(32, "little")
        keys = [generate_keypair(seed_bytes, i) for i in range(nodes)]
        socks = reserve_ports(nodes)
        committee = Committee.new(
            [
                (pk, 1, ("127.0.0.1", s.getsockname()[1]))
                for (pk, _), s in zip(keys, socks)
            ]
        )
        quorum = committee.quorum_threshold()
        backend = make_verifier(verifier, device=device)
        backend.precompute([pk.to_bytes() for pk in committee.authorities])
        service = AsyncVerifyService.for_backend(backend)
        if hasattr(backend, "warmup"):
            # build and stage the device verifier BEFORE any node binds:
            # a cold first wave would stall past the round timeout.  The
            # co-located nodes' claims coalesce into one dispatch
            # stream, so the warm shapes cover whole-committee waves
            # (node/node.py).
            backend.warmup(batch=min(1024, nodes * (quorum + 2)))
            service.warm_buckets()
        launches = None
        if verifier == "cuda":
            from ..gpu import dsm

            launches = dsm.launches

        params = Parameters(timeout_delay=timeout_delay)
        for i, ((name, secret), sock) in enumerate(zip(keys, socks)):
            store = Store(os.path.join(tmp.name, f"db_{i}"))
            stores.append(store)
            queues.append(asyncio.Queue())
            sock.close()  # free the reserved port for this node's receiver
            stacks.append(
                await Consensus.spawn(
                    name,
                    committee,
                    params,
                    SignatureService(secret),
                    store,
                    queues[-1],
                    verifier=backend,
                    bind_host="127.0.0.1",
                )
            )
        for pk, _ in keys:
            reader, writer = await asyncio.open_connection(*committee.address(pk))
            set_nodelay(writer)
            conns.append(_ProducerConn(reader, writer))
        undo_gc = _freeze_boot_objects()
        boot_s = time.perf_counter() - t_boot

        chains: list[list] = [[] for _ in range(nodes)]
        first_commit: dict = {}

        async def drain_commits(i: int) -> None:
            while True:
                block = await queues[i].get()
                chains[i].append((block.round, block.digest()))
                now = loop.time()
                for d in block.payloads:
                    first_commit.setdefault(d, now)

        lags: list[float] = []

        async def heartbeat() -> None:
            while True:
                t0 = loop.time()
                await asyncio.sleep(HEARTBEAT_S)
                lags.append(loop.time() - t0 - HEARTBEAT_S)

        tasks += [asyncio.ensure_future(drain_commits(i)) for i in range(nodes)]
        tasks.append(asyncio.ensure_future(heartbeat()))
        k1_before = launches["verify_compressed"] if launches is not None else 0
        sent_at: dict = {}
        t_start = loop.time()
        sent = await _send_load(
            conns, rate, duration, size, random.Random(seed), sent_at
        )
        t_end = loop.time()
        window = t_end - t_start
        latencies = sorted(
            first_commit[d] - t
            for d, t in sent_at.items()
            if d in first_commit and first_commit[d] <= t_end
        )
        digests = [[d for _, d in c] for c in chains]
        common = min(map(len, digests))
        result = {
            "nodes": nodes,
            "quorum": quorum,
            "rate": rate,
            "duration_s": duration,
            "size": size,
            "verifier": verifier,
            "device": str(getattr(backend, "device", "cpu")),
            "sent": sent,
            "producer_conns_dropped": sum(not c.alive for c in conns),
            "window_s": window,
            "blocks": [sum(1 for r, _ in c if r > 0) for c in chains],
            "chains": digests,
            "common_prefix": common,
            "chains_agree": all(d[:common] == digests[0][:common] for d in digests),
            "committed_payloads": len(latencies),
            "payloads_per_s": len(latencies) / window,
            "latency_mean_s": statistics.fmean(latencies) if latencies else None,
            "latency_p50_s": statistics.median(latencies) if latencies else None,
            "timeouts": sum(s.core.local_timeouts for s in stacks),
            "service": None,
            "k1_launches": (
                launches["verify_compressed"] - k1_before
                if launches is not None else 0
            ),
            "max_loop_lag_s": max(lags, default=0.0),
            "boot_s": boot_s,
        }
        if service.device:
            result["service"] = {
                "dispatches": service.dispatches,
                "device": service.device_dispatches,
                "cpu": service.cpu_dispatches,
                "probe": service.probe_dispatches,
                "device_sigs": service.device_sigs,
                "cpu_sigs": service.cpu_sigs,
                "deadline_misses": service.deadline_misses,
                "peak_inflight": service.peak_inflight,
                "packed_waves": service.packed_waves,
                "stats_line": service.stats_line(),
            }
    finally:
        t_shut = time.perf_counter()
        for c in conns:
            c.close()
        for t in tasks:
            t.cancel()
        for stack in stacks:
            await stack.shutdown()
        for store in stores:
            store.close()
        for s in socks:
            s.close()
        if service is not None and service.device:
            await _drained(service)
            service.close()
        if undo_gc is not None:
            undo_gc()
        if set_cap:
            del os.environ["HOTSTUFF_MAX_PEER_CONNS"]
        tmp.cleanup()
        result["shutdown_s"] = time.perf_counter() - t_shut
    return result


def run_committee(
    nodes: int,
    rate: int,
    duration: float,
    size: int = 512,
    verifier: str = "cuda",
    device=None,
    timeout_delay: int = 5_000,
    seed: int = 0,
) -> dict:
    """Boot ``nodes`` co-located consensus stacks sharing one
    ``make_verifier(verifier, device=device)``, feed them ``rate``
    producer frames a second for ``duration`` seconds, shut them down,
    and return what happened:

    - ``sent``: producer frames sent; ``producer_conns_dropped``: client
      connections dropped because their node stopped reading;
    - ``blocks``: non-genesis blocks each node committed; ``chains``:
      each node's committed block digests in commit order, and whether
      they agree on their common prefix (``chains_agree``);
    - ``committed_payloads`` / ``payloads_per_s``: unique payloads first
      committed inside the load window, over the window;
    - ``latency_mean_s`` / ``latency_p50_s``: a payload's send to its
      first commit at any node, over those payloads;
    - ``timeouts``: local round timeouts over all nodes (view changes);
    - ``service``: the shared wave service's route counts and device
      waves (None for the inline CPU service); ``k1_launches``: verify
      kernel launches after boot;
    - ``max_loop_lag_s``: the worst lag of a 5 ms event-loop heartbeat;
    - ``boot_s`` / ``shutdown_s``: host-clock wall times.
    """
    return asyncio.run(
        _committee(nodes, rate, duration, size, verifier, device, timeout_delay, seed)
    )
