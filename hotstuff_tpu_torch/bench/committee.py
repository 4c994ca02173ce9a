"""Co-located committee driver: n consensus stacks in one event loop,
fed producer frames over TCP, all verifying through one shared verifier.

The in-process counterpart of ``python -m hotstuff_tpu_torch.node
run-many`` plus its producer client, trimmed to the consensus stack:
every node is a ``Consensus.spawn`` stack on localhost, as the JAX
package's end-to-end tests drive them, so that a crash and recovery can
be staged inside the process and the result read from the stacks.  The
load follows ``node/client.py``'s open loop —
``rate`` producer frames a second, each ``encode_producer(digest,
body)`` with a ``size``-byte body, each to ONE node in round-robin
order, through the receiver's producer path, ``PayloadBodies`` and
admission.

    from hotstuff_tpu_torch.bench.committee import run_committee
    result = run_committee(nodes=64, rate=1000, duration=20)

Listener ports come from the OS: each node's socket is bound to port 0
first, the committee is built from the numbers the OS assigned, and
each socket holds its port until the run ends.  The node's receiver
binds beside it (both set ``SO_REUSEADDR`` and only the receiver
listens), so no outgoing connection of the committee can take a node's
port before its receiver binds it, or while a restarted node is down.
Keys and payload bodies are made from ``seed``.

With ``restart`` one node crashes and recovers inside the load window,
the in-process counterpart of killing a node process and starting it
again on its store: its stack is stopped hard, the committee commits
on, and the node is spawned again on the same key, port and store once
the live nodes are ``behind_rounds`` past its commit cursor.  It then
catches up from a peer's certified snapshot (``consensus/statesync.py``)
before it enters the protocol:

    result = run_committee(nodes=64, rate=1000, duration=60, restart={
        "node": 1, "down_at_s": 5.0, "behind_rounds": 16, "deadline_s": 30.0})

With ``wan=True`` the nodes' links carry the reference's five-region
WAN delays (a ``network/wan.build_spec`` over the committee's addresses,
handed to every ``Consensus.spawn`` through ``HOTSTUFF_WAN_SPEC``, as
the node CLI's environment does); with ``telemetry=True`` every stack
gets its node's telemetry handle, flow accounting included, as a node
started with ``--metrics-port`` does, and with ``journal_dir`` each also
writes its flight-recorder journal there, as ``--journal-dir`` does.

With ``adversary`` (a spec of ``faults/adversary.py`` whose rules name
node indexes ``0..nodes-1``, the order of the run's keys) the named
nodes attack: the spec gets the committee's addresses and the boot's
wall time, and reaches every ``Consensus.spawn`` through
``HOTSTUFF_ADVERSARY``, as the node CLI's ``--adversary`` does:

    result = run_committee(nodes=4, rate=200, duration=8, verifier="cpu",
                           adversary={"seed": 3, "adversary": [
                               {"policy": "withhold", "node": 0}]})
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import random
import re
import socket
import statistics
import tempfile
import time

from ..consensus import Committee, Consensus, Parameters
from ..consensus import core as core_module
from ..consensus.wire import (
    STATE_READ_LEDGER,
    decode_state_value,
    encode_producer,
    encode_state_read,
)
from ..crypto import Digest
from ..crypto.scheme import bls_pop, keygen_deterministic, make_signing_service
from ..crypto.async_service import AsyncVerifyService
from ..network.framing import read_frame, set_nodelay, write_frame
from ..node import make_verifier
from ..node.main import _freeze_boot_objects, _peer_conn_cap, _raise_fd_limit
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
#: payloads committed during an outage that are read back from the
#: restarted node and from a live one
LEDGER_READS = 200
#: the core's log lines a committee run reads (its log contract)
RE_STATE_ROOT = re.compile(r"State root (\d+) -> (\S+) \(round (\d+)\)$")
RE_CURSOR = re.compile(r"State sync advanced commit cursor (\d+) -> (\d+) ")
RE_COMMITTED = re.compile(r"Committed block (\d+) -> (\S+)$")


def reserve_ports(n: int, host: str = "127.0.0.1") -> list[socket.socket]:
    """``n`` sockets bound to ports the OS assigns on ``host``, not
    listening.  Each port stays reserved until its socket is closed.  A
    listener that sets ``SO_REUSEADDR`` (asyncio's and the native
    transport's do) can bind the port while its socket stays open, which
    keeps the port from every other socket, an outgoing connection's
    included, for as long as the caller holds it; or the caller closes
    the socket just before binding a listener there.  OS-assigned ports
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


class _NodeLogs(logging.Handler):
    """Reads the per-node core log lines of a co-located committee: each
    ``State root`` line into ``roots[i]`` as ``{version: (root_hex,
    round)}`` (a node that reports another root for a version it
    reported before is listed in ``conflicts``), and each ``State sync
    advanced commit cursor`` line into ``cursors[i]``, and with
    ``commits=True`` each ``Committed block`` line into ``reported[i]``
    as ``(round, digest)``: the chain a node reports, which is not the
    chain it holds when it is a colluder's shadow committer.  The line
    is parsed as logged, which holds the core to its log contract; the
    full root comes from the record's argument, whose display is what
    the line shows."""

    def __init__(self, names, commits: bool = False):
        super().__init__(logging.INFO)
        self.roots: list[dict] = [{} for _ in names]
        self.reported: list[list] | None = (
            [[] for _ in names] if commits else None
        )
        self.conflicts: list = []
        self.cursors: dict = {}
        self._index: dict[str, int] = {}
        self._loggers: list = []
        tags = [str(name)[:8] for name in names]
        if len(set(tags)) != len(tags):
            raise ValueError("two nodes share a log name; use another seed")
        for i, tag in enumerate(tags):
            logger = logging.getLogger(f"{core_module.__name__}.{tag}")
            self._index[logger.name] = i
            self._loggers.append((logger, logger.level))
            logger.setLevel(logging.INFO)
            logger.addHandler(self)

    def emit(self, record: logging.LogRecord) -> None:
        i = self._index.get(record.name)
        if i is None:
            return
        msg = record.getMessage()
        m = RE_STATE_ROOT.match(msg)
        if m is not None:
            root = record.args[1]
            entry = (root.to_bytes().hex(), int(m[3]))
            if str(root) != m[2]:
                self.conflicts.append((i, int(m[1]), "line", msg))
            prev = self.roots[i].setdefault(int(m[1]), entry)
            if prev != entry:
                self.conflicts.append((i, int(m[1]), prev, entry))
            return
        m = RE_CURSOR.match(msg)
        if m is not None:
            self.cursors[i] = (int(m[1]), int(m[2]))
            return
        if self.reported is not None:
            m = RE_COMMITTED.match(msg)
            if m is not None:
                self.reported[i].append((int(m[1]), m[2]))

    def close(self) -> None:
        for logger, level in self._loggers:
            logger.removeHandler(self)
            logger.setLevel(level)
        self._loggers.clear()
        super().close()


def _rounds_agree(chains) -> bool:
    """Every round that two chains both committed maps to one digest (a
    chain with a snapshot gap still compares)."""
    seen: dict = {}
    return all(seen.setdefault(r, d) == d for chain in chains for r, d in chain)


def _roots_agree(roots, conflicts) -> bool:
    """Every version that two nodes both applied has one root."""
    seen: dict = {}
    return not conflicts and all(
        seen.setdefault(v, root) == root
        for node in roots for v, (root, _) in node.items()
    )


async def _ledger_reads(address, digests, timeout: float = 5.0) -> list:
    """``(found, entry_round, seq bytes)`` for each payload digest, read
    from the node at ``address`` with ``TAG_STATE_READ`` frames."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(*address), timeout
    )
    try:
        out = []
        for d in digests:
            write_frame(writer, encode_state_read(STATE_READ_LEDGER, d.to_bytes()))
            reply = decode_state_value(
                await asyncio.wait_for(read_frame(reader), timeout)
            )
            out.append((reply.found, reply.entry_round, reply.value))
        return out
    finally:
        writer.transport.abort()


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
    nodes, rate, duration, size, verifier, device, timeout_delay, sync_retry_delay,
    seed, restart, transport, scheme="ed25519", wan=False, telemetry=False,
    adversary=None, journal_dir=None,
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
    down: set = set()  # nodes whose stack is stopped
    stopped: list = []  # stacks stopped by the outage
    tasks: list[asyncio.Task] = []
    drains: dict = {}
    conns: list[_ProducerConn] = []
    undo_gc = None
    logs = None
    outage = None
    result: dict = {}
    wan_before = os.environ.get("HOTSTUFF_WAN_SPEC")
    adversary_before = os.environ.get("HOTSTUFF_ADVERSARY")
    journals: list = []
    try:
        if set_cap:
            os.environ["HOTSTUFF_MAX_PEER_CONNS"] = cap
            log.info("fd limit too low for %d nodes: pools capped at %s", nodes, cap)
        seed_bytes = seed.to_bytes(32, "little")
        keys = [keygen_deterministic(scheme, seed_bytes, i) for i in range(nodes)]
        pops = (
            {pk: bls_pop(secret.to_bytes()) for pk, secret in keys}
            if scheme == "bls" else None
        )
        socks = reserve_ports(nodes)
        committee = Committee.new(
            [
                (pk, 1, ("127.0.0.1", s.getsockname()[1]))
                for (pk, _), s in zip(keys, socks)
            ],
            scheme=scheme,
            pops=pops,
        )
        quorum = committee.quorum_threshold()
        wan_regions = None
        if wan:
            from ..network.wan import build_spec

            spec = build_spec([committee.address(pk) for pk, _ in keys])
            spec_path = os.path.join(tmp.name, "wan.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            os.environ["HOTSTUFF_WAN_SPEC"] = spec_path
            wan_regions = dict(
                collections.Counter(spec["regions"].values())
            )
        if adversary is not None:
            spec = dict(adversary)
            spec.setdefault(
                "nodes",
                {"%s:%d" % committee.address(pk): i for i, (pk, _) in enumerate(keys)},
            )
            spec.setdefault("epoch_unix", time.time())
            spec_path = os.path.join(tmp.name, "adversary.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            os.environ["HOTSTUFF_ADVERSARY"] = spec_path
        tels = None
        if telemetry or journal_dir is not None:
            from .. import telemetry as telemetry_module

            telemetry_module.enable()
            tels = [
                telemetry_module.for_node(str(pk)[:8]) for pk, _ in keys
            ]
            if journal_dir is not None:
                from ..telemetry.journal import Journal

                os.makedirs(journal_dir, exist_ok=True)
                for tel in tels:
                    journals.append(Journal(tel.node, journal_dir))
                    tel.attach_journal(journals[-1])
        backend = make_verifier(verifier, scheme, device=device)
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
        if verifier == "cuda" and scheme == "ed25519":
            from ..gpu import dsm

            launches = dsm.launches

        sync: dict = {}
        logs = _NodeLogs([pk for pk, _ in keys], commits=adversary is not None)
        params = Parameters(
            timeout_delay=timeout_delay, sync_retry_delay=sync_retry_delay
        )

        async def spawn(i: int) -> None:
            name, secret = keys[i]
            store = Store(os.path.join(tmp.name, f"db_{i}"))
            try:
                stack = await Consensus.spawn(
                    name,
                    committee,
                    params,
                    make_signing_service(scheme, secret),
                    store,
                    queues[i],
                    verifier=backend,
                    bind_host="127.0.0.1",
                    transport=transport,
                    telemetry=tels[i] if tels is not None else None,
                )
            except BaseException:
                store.close()
                raise
            stores[i], stacks[i] = store, stack

        for i in range(nodes):
            stacks.append(None)
            stores.append(None)
            queues.append(asyncio.Queue())
            # the receiver binds beside the reservation, which stays
            # until the run ends: a restarted node's port is never free
            await spawn(i)

        async def connect(i: int) -> _ProducerConn:
            reader, writer = await asyncio.open_connection(
                *committee.address(keys[i][0])
            )
            set_nodelay(writer)
            return _ProducerConn(reader, writer)

        for i in range(nodes):
            conns.append(await connect(i))
        undo_gc = _freeze_boot_objects()
        boot_s = time.perf_counter() - t_boot

        chains: list[list] = [[] for _ in range(nodes)]
        first_commit: dict = {}
        first_after: dict = {}  # node -> loop time of its first commit after a restart

        async def drain_commits(i: int, queue: asyncio.Queue) -> None:
            while True:
                block = await queue.get()
                chains[i].append((block.round, block.digest()))
                now = loop.time()
                if block.round > 0:
                    first_after.setdefault(i, now)
                for d in block.payloads:
                    first_commit.setdefault(d, now)

        lags: list[tuple[float, float]] = []

        async def heartbeat() -> None:
            while True:
                t0 = loop.time()
                await asyncio.sleep(HEARTBEAT_S)
                lags.append((t0, loop.time() - t0 - HEARTBEAT_S))

        for i in range(nodes):
            drains[i] = asyncio.ensure_future(drain_commits(i, queues[i]))
        tasks.append(asyncio.ensure_future(heartbeat()))

        def live_round() -> int:
            return max(
                s.core.last_committed_round
                for j, s in enumerate(stacks) if j not in down
            )

        async def crash_and_recover(spec: dict, t_load: float) -> None:
            k = spec["node"]
            await asyncio.sleep(max(0.0, t_load + spec["down_at_s"] - loop.time()))
            # stop hard: tasks, listener, sockets and store go; nothing
            # more is persisted than the core already wrote
            down.add(k)
            conns[k].close()
            stack = stacks[k]
            t_down = loop.time()
            await stack.shutdown()
            stores[k].close()
            stopped.append(stack)
            tasks.append(drains.pop(k))  # drains what the stack committed
            cursor = stack.core.last_committed_round
            sync.update(node=k, down_s=t_down - t_load, cursor=cursor, t_down=t_down)
            target = cursor + spec["behind_rounds"]
            deadline = t_down + spec["deadline_s"]
            while live_round() < target:
                if loop.time() >= deadline:
                    raise RuntimeError(
                        f"restart: the live nodes reached round {live_round()}, "
                        f"not {target}, within {spec['deadline_s']} s"
                    )
                await asyncio.sleep(0.05)
            sync["behind_rounds"] = live_round() - cursor
            sync["restart_at"] = len(chains[k])
            first_after.pop(k, None)
            queues[k] = asyncio.Queue()
            drains[k] = asyncio.ensure_future(drain_commits(k, queues[k]))
            before = os.environ.get("HOTSTUFF_STATE_SYNC")
            os.environ["HOTSTUFF_STATE_SYNC"] = "auto"
            try:
                t_up = loop.time()
                await spawn(k)
            finally:
                if before is None:
                    del os.environ["HOTSTUFF_STATE_SYNC"]
                else:
                    os.environ["HOTSTUFF_STATE_SYNC"] = before
            down.discard(k)
            client = stacks[k].core.state_sync
            if client is None or client.outcome is not None:
                raise RuntimeError("restart: the node started no state-sync client")
            # the catch-up has not run yet (spawn returns before the
            # core's task does): a verifier host of its own, on the same
            # shared device, counts the routes of its certificate checks
            client.verifier = sync["verifier"] = make_verifier(verifier, device=device)
            sync["t_up"] = t_up
            sync["restart_s"] = t_up - t_load
            conns[k] = await connect(k)

        k1_before = launches["verify_compressed"] if launches is not None else 0
        sent_at: dict = {}
        t_start = loop.time()
        if restart is not None:
            outage = asyncio.ensure_future(crash_and_recover(dict(restart), t_start))
        sent = await _send_load(
            conns, rate, duration, size, random.Random(seed), sent_at
        )
        t_end = loop.time()
        snapshots = (
            {t.node: t.snapshot() for t in tels} if tels is not None else None
        )
        if outage is not None:
            await outage  # raises when the restart failed
        window = t_end - t_start
        latencies = sorted(
            first_commit[d] - t
            for d, t in sent_at.items()
            if d in first_commit and first_commit[d] <= t_end
        )
        digests = [[d for _, d in c] for c in chains]
        common = min(map(len, digests))
        worst = max(lags, key=lambda tl: tl[1], default=(t_start, 0.0))
        whole = [d for i, d in enumerate(digests) if i != sync.get("node")]
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
            # per round over every chain, and as a common prefix over
            # the chains without a restart's gap
            "chains_agree": _rounds_agree(chains) and all(
                d[:common] == whole[0][:common] for d in whole
            ),
            "committed_payloads": len(latencies),
            "payloads_per_s": len(latencies) / window,
            "latency_mean_s": statistics.fmean(latencies) if latencies else None,
            "latency_p50_s": statistics.median(latencies) if latencies else None,
            "timeouts": sum(s.core.local_timeouts for s in stacks + stopped),
            "service": None,
            "k1_launches": (
                launches["verify_compressed"] - k1_before
                if launches is not None else 0
            ),
            "max_loop_lag_s": worst[1],
            "max_loop_lag_at_s": worst[0] - t_start,
            "boot_s": boot_s,
            "state_roots": logs.roots,
            "roots_agree": _roots_agree(logs.roots, logs.conflicts),
            "state_sync": None,
            "ledger_reads": None,
            "wan_regions": wan_regions,
            "snapshots": snapshots,
            "adversary": None,
        }
        if adversary is not None:
            index = {pk: i for i, (pk, _) in enumerate(keys)}
            planes = {}
            for i, stack in enumerate(stacks):
                if stack is not None and stack.core.adversary is not None:
                    planes[i] = stack.core.adversary.stats()
            result["adversary"] = {
                # node index -> its plane's stats (attacking nodes only)
                "planes": planes,
                "vote_conflicts": [s.core.aggregator.vote_conflicts for s in stacks],
                "reported_chains": logs.reported,
                # round r's leader is node leader_order[r % nodes]
                "leader_order": [index[pk] for pk in committee.sorted_keys()],
            }
        if restart is not None:
            k = sync["node"]
            result["state_sync"] = _sync_report(
                sync, stacks[k], logs.cursors.get(k), chains[k], first_after.get(k),
                lags,
            )
            # payloads first committed while the node was down, read back
            # from it and from a live node
            during = sorted(
                (t, d) for d, t in first_commit.items()
                if sync["t_down"] < t < sync["t_up"]
            )
            picked = [d for _, d in during[:: max(1, len(during) // LEDGER_READS)]]
            picked = picked[:LEDGER_READS]
            mine = await _ledger_reads(committee.address(keys[k][0]), picked)
            theirs = await _ledger_reads(
                committee.address(keys[(k + 1) % nodes][0]), picked
            )
            result["ledger_reads"] = {
                "reads": len(picked),
                "found": sum(f for f, _, _ in mine),
                "matched": sum(a[0] and a == b for a, b in zip(mine, theirs)),
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
                "zero_copy_waves": service.zero_copy_waves,
                "zero_copy_sigs": service.zero_copy_sigs,
                "fallback_waves": service.fallback_waves,
                "stats_line": service.stats_line(),
            }
    finally:
        t_shut = time.perf_counter()
        if outage is not None and not outage.done():
            outage.cancel()
            await asyncio.gather(outage, return_exceptions=True)
        for c in conns:
            c.close()
        for t in tasks + list(drains.values()):
            t.cancel()
        for i, stack in enumerate(stacks):
            if stack is not None and i not in down:
                await stack.shutdown()
        for i, store in enumerate(stores):
            if store is not None and i not in down:
                store.close()
        for s in socks:
            s.close()
        if service is not None and service.device:
            await _drained(service)
            service.close()
        if logs is not None:
            logs.close()
        for journal in journals:
            journal.close()
        if undo_gc is not None:
            undo_gc()
        if set_cap:
            del os.environ["HOTSTUFF_MAX_PEER_CONNS"]
        if wan_before is None:
            os.environ.pop("HOTSTUFF_WAN_SPEC", None)
        else:
            os.environ["HOTSTUFF_WAN_SPEC"] = wan_before
        if adversary is not None:
            if adversary_before is None:
                os.environ.pop("HOTSTUFF_ADVERSARY", None)
            else:
                os.environ["HOTSTUFF_ADVERSARY"] = adversary_before
        tmp.cleanup()
        result["shutdown_s"] = time.perf_counter() - t_shut
    return result


def _sync_report(sync, stack, cursor_line, chain, first_commit_at, lags) -> dict:
    """What the restarted node's catch-up did, from its sync client's
    outcome, its log lines and the run's clocks."""
    outcome = stack.core.state_sync.outcome or {}
    t_up = sync["t_up"]
    end = t_up + outcome.get("seconds", 0.0)
    return {
        "node": sync["node"],
        "down_at_s": sync["down_s"],
        "restart_at_s": sync["restart_s"],
        "cursor_at_stop": sync["cursor"],
        "rounds_behind": sync["behind_rounds"],
        "adopted": outcome.get("adopted", False),
        "kind": outcome.get("kind"),
        "offers": outcome.get("offers", 0),
        "chunks": outcome.get("chunk_count", 0),
        "reasks": outcome.get("reasks", 0),
        "entries": outcome.get("entries", 0),
        "version": outcome.get("version"),
        "round": outcome.get("round"),
        "cursor_advanced": cursor_line,
        "sync_s": outcome.get("seconds"),
        "first_commit_s": (
            first_commit_at - t_up if first_commit_at is not None else None
        ),
        "blocks_after": sum(1 for r, _ in chain[sync["restart_at"]:] if r > 0),
        "qc_check_routes": dict(getattr(sync["verifier"], "routes", {})),
        "max_loop_lag_in_sync_s": max(
            (lag for t, lag in lags if t_up <= t <= end),
            default=0.0,
        ),
    }


def run_committee(
    nodes: int,
    rate: int,
    duration: float,
    size: int = 512,
    verifier: str = "cuda",
    device=None,
    timeout_delay: int = 5_000,
    seed: int = 0,
    restart: dict | None = None,
    sync_retry_delay: int = 10_000,
    transport: str = "asyncio",
    scheme: str = "ed25519",
    wan: bool = False,
    telemetry: bool = False,
    adversary: dict | None = None,
    journal_dir: str | None = None,
) -> dict:
    """Boot ``nodes`` co-located consensus stacks of a ``scheme``
    committee (``"bls"``: BLS12-381 keys with their proofs of possession,
    compact certificates) sharing one
    ``make_verifier(verifier, scheme, device=device)``, feed them ``rate``
    producer frames a second for ``duration`` seconds, shut them down,
    and return what happened:

    - ``sent``: producer frames sent; ``producer_conns_dropped``: client
      connections dropped because their node stopped reading;
    - ``blocks``: non-genesis blocks each node committed; ``chains``:
      each node's committed block digests in commit order;
      ``chains_agree``: every round two nodes both committed has one
      digest, and the chains of nodes that never restarted agree on
      their common prefix (``common_prefix`` blocks);
    - ``committed_payloads`` / ``payloads_per_s``: unique payloads first
      committed inside the load window, over the window;
    - ``latency_mean_s`` / ``latency_p50_s``: a payload's send to its
      first commit at any node, over those payloads;
    - ``timeouts``: local round timeouts over all nodes (view changes);
    - ``service``: the shared wave service's route counts, device
      waves, and waves adopted from an ingest arena or resynced (None
      for the inline CPU service); ``k1_launches``: verify kernel
      launches after boot;
    - ``max_loop_lag_s``: the worst lag of a 5 ms event-loop heartbeat,
      and ``max_loop_lag_at_s`` when it began, in seconds into the load
      window;
    - ``boot_s`` / ``shutdown_s``: host-clock wall times;
    - ``state_roots``: per node, ``{version: (root_hex, round)}`` from
      its ``State root`` log lines; ``roots_agree``: every version two
      nodes both applied has one root.

    ``timeout_delay`` and ``sync_retry_delay`` (ms) are the nodes'
    ``Parameters``; ``transport`` (``"asyncio"`` or ``"native"``) goes
    to every stack's ``Consensus.spawn``.  ``restart`` (None, or a dict such as ``{"node": 1, "down_at_s": 5.0,
    "behind_rounds": 16, "deadline_s": 30.0}``) crashes and recovers
    one node inside the load window: ``down_at_s`` into the window its
    stack is stopped hard (tasks, listener, sockets, store; the client's
    connection to it is dropped); once the live nodes' highest commit
    round is ``behind_rounds`` past its commit cursor it is spawned again
    on the same key, port and store under ``HOTSTUFF_STATE_SYNC=auto``
    (the sync lag is ``HOTSTUFF_STATE_SYNC_LAG``, 8 rounds when unset),
    and the client connects to it again.  It raises when the live nodes
    do not get that far within ``deadline_s`` of the stop.  The result
    then also holds:

    - ``state_sync``: the restarted node's catch-up — whether a snapshot
      was adopted, delta or full, offers seen, chunks, re-asks, entries,
      the adopted version and round, the rounds it was behind, the
      ``State sync advanced commit cursor`` line's two rounds, the sync
      seconds, the seconds from the restart to its first commit, the
      blocks it committed after the restart, the routes its inline
      certificate checks took while catching up, and the worst loop lag
      in that time;
    - ``ledger_reads``: up to 200 payloads first committed while the
      node was down, read with ``TAG_STATE_READ`` frames from it and
      from a live node after the window: ``reads``, ``found`` at the
      restarted node, and ``matched`` (found, with the same round and
      position as the live node's answer).

    ``wan=True``: ``HOTSTUFF_WAN_SPEC`` names a ``build_spec`` over the
    committee's addresses for the run (``transport="asyncio"`` only, as
    in the reference; ``wan_regions`` counts the nodes a region).
    ``telemetry=True``: turns telemetry on for the process
    (``telemetry.enable()``, as ``--metrics-port`` does) and spawns every
    stack with ``telemetry.for_node``; ``snapshots`` holds each node's
    snapshot document taken at the end of the load window.
    ``journal_dir``: telemetry on, and every node journals into that
    directory (flushed at the end of the run).

    ``adversary``: a spec of ``faults/adversary.py`` whose rules name
    node indexes (its ``nodes`` map and ``epoch_unix`` are filled in from
    the committee and the boot when absent), handed to every stack
    through ``HOTSTUFF_ADVERSARY``; ``adversary`` in the result then
    holds ``planes`` (node index -> ``stats()`` of each attacking node's
    plane), ``vote_conflicts`` (each node's aggregator's count of second
    votes), ``reported_chains`` (each node's ``Committed block`` lines
    as ``(round, digest)``, which a shadow committer reports apart from
    its ``chains``) and ``leader_order`` (round r's leader is node
    ``leader_order[r % nodes]``).
    """
    return asyncio.run(
        _committee(
            nodes, rate, duration, size, verifier, device, timeout_delay,
            sync_retry_delay, seed, restart, transport, scheme, wan, telemetry,
            adversary, journal_dir,
        )
    )
