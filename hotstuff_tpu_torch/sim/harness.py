"""One virtual-time committee in a process.

A copy of ``hotstuff_tpu.sim.harness``.  The stores stay on the
pure-Python ``WalEngine``, as the reference's do: a crash appends its
torn tail after per-put flushes, and ``StateMachine.apply_block`` only
batches on an engine that has ``batch()`` (the native one), so a crash
leaves the bytes the reference leaves.

``SimCluster`` boots N full consensus stacks (core, proposer,
synchronizer, aggregator, state machine, state-sync, reconfig) on the
current — virtual — event loop with ``transport="sim"``, then executes a
schedule against them: a paced payload feeder, seeded crash-points with
WAL torn-tail emulation, restarts through the REAL recovery + state-sync
path, and sponsored reconfiguration ops submitted over the in-memory
network exactly as an operator would submit them over TCP.

Everything here is deterministic given the schedule: node keys come from
a fixed seed, payloads are ``sha512("sim|<seed>|<k>")``, torn-tail bytes
are drawn from ``Random("sim-torn|<seed>|<node>")``, and all timing is
virtual-loop timers.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import struct

from ..consensus import Committee, CommitteeSchedule, Parameters
from ..consensus.consensus import Consensus
from ..consensus.reconfig import ReconfigOp
from ..consensus.wire import encode_reconfig
from ..crypto import (
    Digest,
    Signature,
    SignatureService,
    generate_keypair,
)
from ..network.framing import send_frame
from ..store import Store
from ..store.engine import WalEngine
from ..telemetry import NodeTelemetry
from ..telemetry.journal import Journal
from ..telemetry.metrics import Registry
from .transport import SimNet

log = logging.getLogger(__name__)

#: every sim committee binds 127.0.0.1:<SIM_BASE_PORT + i> on its own
#: private SimNet, so the value never collides with anything real
SIM_BASE_PORT = 7000

#: deterministic committee keys (same scheme as tests/common.py)
KEY_SEED = bytes(32)

#: consensus timing in VIRTUAL milliseconds — tight, because virtual
#: timeouts are free: a view change costs CPU, not wall-clock
SIM_TIMEOUT_MS = 1_000
SIM_SYNC_RETRY_MS = 2_000
# cap below the post-heal runway (duration - EVENT_MAX_END): a node
# whose view timer backed off during a long partition must fire at
# least once before the run ends, or every heal-at-the-edge schedule
# reads as a liveness failure
SIM_TIMEOUT_CAP_MS = 2_000


class SimNode:
    """One committee member's mortal half: store + spawned stack."""

    def __init__(self, idx: int, pk, sk, path: str):
        self.idx = idx
        self.pk = pk
        self.sk = sk
        self.path = path
        self.store: Store | None = None
        self.stack: Consensus | None = None
        self.commits: asyncio.Queue | None = None
        self.drain: asyncio.Task | None = None
        self.tel: NodeTelemetry | None = None
        self.alive = False
        self.restarts = 0


class SimCluster:
    """Boots a committee from a schedule and executes its events."""

    def __init__(self, schedule: dict, workdir: str, net: SimNet):
        self.schedule = schedule
        self.workdir = workdir
        self.net = net
        self.seed = int(schedule["seed"])
        self.n = int(schedule["nodes"])
        self.duration = float(schedule["duration_s"])
        #: payload feed rate in payloads per virtual second
        self.rate = float(os.environ.get("HOTSTUFF_SIM_RATE", "8"))
        pairs = [generate_keypair(KEY_SEED, i) for i in range(self.n)]
        pairs.sort(key=lambda kp: kp[0])
        self.pairs = pairs
        self.committee = Committee.new(
            [
                (pk, 1, ("127.0.0.1", SIM_BASE_PORT + i))
                for i, (pk, _) in enumerate(pairs)
            ],
            epoch=1,
        )
        # Reconfiguration needs splice(); wrap only when the schedule
        # actually exercises it, so plain runs keep the cheaper object.
        if any(ev["kind"] == "reconfig" for ev in schedule.get("events", ())):
            self.membership = CommitteeSchedule([(1, self.committee)])
        else:
            self.membership = self.committee
        self.params = Parameters(
            timeout_delay=SIM_TIMEOUT_MS,
            sync_retry_delay=SIM_SYNC_RETRY_MS,
            timeout_cap_ms=SIM_TIMEOUT_CAP_MS,
        )
        self.nodes = [
            SimNode(i, pk, sk, os.path.join(workdir, f"store-{i}"))
            for i, (pk, sk) in enumerate(pairs)
        ]
        # node short-name -> [flow table per boot] (telemetry/flows.py
        # ``table()``), harvested at each crash/stop: all charges are
        # driven by virtual-time scheduling, so a same-seed double-run
        # must reproduce these byte-for-byte (SimVerdict.flows)
        self.flow_tables: dict[str, list[dict]] = {}

    #: ``str(pk)[:8] -> node index``: the per-actor logger suffix
    #: (e.g. ``hotstuff_tpu_torch.consensus.core.<pk8>``), used by the runner
    #: to attribute captured log records to committee members.
    def prefix_map(self) -> dict[str, int]:
        return {str(pk)[:8]: i for i, (pk, _) in enumerate(self.pairs)}

    # -- lifecycle ------------------------------------------------------

    async def start_node(self, i: int) -> None:
        node = self.nodes[i]
        node.store = Store(node.path, engine=WalEngine(node.path))
        node.commits = asyncio.Queue()
        # Per-node flight recorder on a PRIVATE registry (the global one
        # belongs to the host process).  resume=True so a crash-restart
        # keeps the pre-crash segments: the merge dedups the (node, seq)
        # overlap and critical-path attribution spans the whole run.
        short = str(node.pk)[:8]
        node.tel = NodeTelemetry(short, registry=Registry())
        node.tel.attach_journal(
            Journal(
                short,
                os.path.join(self.workdir, "journals"),
                resume=node.restarts > 0,
            )
        )
        node.stack = await Consensus.spawn(
            node.pk,
            self.membership,
            self.params,
            SignatureService(node.sk),
            node.store,
            node.commits,
            bind_host="127.0.0.1",
            transport="sim",
            telemetry=node.tel,
        )
        node.drain = asyncio.get_running_loop().create_task(
            self._drain(node.commits), name=f"sim-drain-{i}"
        )
        node.alive = True

    @staticmethod
    async def _drain(q: asyncio.Queue) -> None:
        while True:
            await q.get()

    async def crash(self, i: int, torn_bytes: int = 0) -> None:
        """Kill node ``i`` mid-flight and emulate a torn in-flight WAL
        append: a partial record (or bare header claiming more bytes
        than follow) lands at the tail, exactly what a power cut during
        ``WalEngine.put`` leaves behind.  Recovery's ``_replay`` must
        truncate it.  We APPEND garbage rather than truncate completed
        records — the engine flushes per put, so completed records are
        durable by contract, and deleting a persisted vote would
        manufacture a genuine (not injected) double-vote."""
        node = self.nodes[i]
        if not node.alive:
            return
        node.alive = False
        await node.stack.shutdown()
        node.drain.cancel()
        try:
            await node.drain
        except asyncio.CancelledError:
            pass
        node.store.close()
        self._harvest_flows(node)
        if node.tel is not None and node.tel.journal is not None:
            node.tel.journal.close()
        k = max(0, int(torn_bytes))
        if k:
            rng = random.Random(f"sim-torn|{self.seed}|{i}")
            if k < 8:
                tail = bytes(rng.randrange(256) for _ in range(k))
            else:
                # complete 8-byte header promising a 32B key + 200B
                # value that never made it to disk
                tail = struct.pack("<II", 32, 200) + bytes(
                    rng.randrange(256) for _ in range(k - 8)
                )
            with open(os.path.join(node.path, "wal.log"), "ab") as f:
                f.write(tail)
        log.info("sim: node %d crashed (torn tail %dB)", i, k)

    async def restart(self, i: int) -> None:
        node = self.nodes[i]
        if node.alive:
            return
        # bump BEFORE start_node: restarts > 0 is its resume signal
        node.restarts += 1
        await self.start_node(i)
        log.info("sim: node %d restarted", i)

    async def stop_all(self) -> None:
        for node in self.nodes:
            if not node.alive:
                continue
            node.alive = False
            await node.stack.shutdown()
            node.drain.cancel()
            try:
                await node.drain
            except asyncio.CancelledError:
                pass
            node.store.close()
            self._harvest_flows(node)
            if node.tel is not None and node.tel.journal is not None:
                node.tel.journal.close()

    def _harvest_flows(self, node: SimNode) -> None:
        """Snapshot the node's flow table at teardown (one entry per
        boot — the accountant is rebuilt on restart)."""
        tel = node.tel
        flows = getattr(tel, "flows", None) if tel is not None else None
        if flows is None or not flows.enabled:
            return
        self.flow_tables.setdefault(str(node.pk)[:8], []).append(
            flows.table()
        )

    # -- schedule execution ---------------------------------------------

    async def run(self) -> None:
        for i in range(self.n):
            await self.start_node(i)
        loop = asyncio.get_running_loop()
        aux = [loop.create_task(self._feed(), name="sim-feeder")]
        for ev in self.schedule.get("events", ()):
            if ev["kind"] == "crash":
                aux.append(
                    loop.create_task(self._crash_event(ev), name="sim-crash")
                )
            elif ev["kind"] == "reconfig":
                aux.append(
                    loop.create_task(
                        self._reconfig_event(ev), name="sim-reconfig"
                    )
                )
        try:
            await asyncio.sleep(self.duration)
        finally:
            for t in aux:
                t.cancel()
            for t in aux:
                try:
                    await t
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
            await self.stop_all()

    async def _feed(self) -> None:
        """Paced payload feed to every live node's producer queue.  All
        nodes see the same payload stream (the proposer's dedup keeps
        one commit per digest); pacing is virtual, so a 12s run feeds
        ~12*rate payloads regardless of wall-clock."""
        interval = 1.0 / max(self.rate, 0.001)
        k = 0
        while True:
            payload = Digest.of(f"sim|{self.seed}|{k}".encode())
            k += 1
            for node in self.nodes:
                if node.alive:
                    try:
                        node.stack.tx_producer.put_nowait(payload)
                    except asyncio.QueueFull:
                        pass  # backpressure: drop, like a real client
            await asyncio.sleep(interval)

    async def _crash_event(self, ev: dict) -> None:
        await asyncio.sleep(max(0.0, ev["at"]))
        await self.crash(ev["node"], ev.get("torn_bytes", 0))
        restart_at = ev.get("restart_at")
        if restart_at is not None:
            await asyncio.sleep(max(0.0, restart_at - ev["at"]))
            await self.restart(ev["node"])

    async def _reconfig_event(self, ev: dict) -> None:
        """Submit a sponsored epoch-bump op to every member's consensus
        port, the same frames an operator's ``reconfig`` CLI sends over
        TCP.  Membership-preserving (same authorities, epoch 2): the
        run exercises admission, 2-chain commit, splice and activation
        without orphaning any node."""
        await asyncio.sleep(max(0.0, ev["at"]))
        new_com = Committee.new(
            [
                (pk, 1, ("127.0.0.1", SIM_BASE_PORT + i))
                for i, (pk, _) in enumerate(self.pairs)
            ],
            epoch=2,
        )
        pk_s, sk_s = self.pairs[int(ev["sponsor"]) % self.n]
        op = ReconfigOp(
            new_committee=new_com, margin=int(ev["margin"]), sponsor=pk_s
        )
        op.signature = Signature.new(Digest(op.digest()), sk_s)
        frame = encode_reconfig(op)
        for i in range(self.n):
            try:
                _reader, writer = await self.net.open_connection(
                    "127.0.0.1", SIM_BASE_PORT + i
                )
                await send_frame(writer, frame)
                await asyncio.sleep(0.05)  # let the handler drain first
                writer.close()
            except (ConnectionRefusedError, ConnectionResetError):
                continue  # crashed member; the live quorum suffices
        log.info(
            "sim: reconfig op submitted (sponsor %d margin %d)",
            ev["sponsor"],
            ev["margin"],
        )


__all__ = ["KEY_SEED", "SIM_BASE_PORT", "SimCluster", "SimNode"]
