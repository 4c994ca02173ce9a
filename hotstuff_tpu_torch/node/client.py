"""Benchmark client: an open-loop producer-path load generator.

A copy of ``hotstuff_tpu.node.client``; its log lines are the harness's
contract (``benchmark/logs.py``).

    python -m hotstuff_tpu_torch.node.client --committee committee.json \
        --rate 1000 --size 512 --duration 20 --warmup 2

The reference's client (node/src/client.rs:40-153) still speaks the
deleted mempool's "front" port and can't drive the fork (SURVEY.md §2.5
stale-fork caveat). This client speaks the fork's actual ingest path:
``Producer(Digest)`` messages on the consensus port
(consensus/src/consensus.rs:151-160), round-robining each payload to
``--homes`` live nodes (default 1 — the single-client equivalent of the
reference harness's one-client-per-node topology, local.py:79-91,
keeping proposer queues disjoint so concurrent leaders never fill
blocks with duplicates).

Kept from the reference's methodology (client.rs:103-152):
- wait for every node's port to be listening, then an extra warm-up;
- open-loop rate control in PRECISION bursts per second;
- one tagged sample payload per burst, logged for latency measurement;
- a "rate too high" warning when a burst overruns its slot.

NOTE: the sample log entries are used to compute performance.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from ..crypto import Digest
from ..network.framing import read_frame, set_nodelay, write_frame
from .config import read_committee

log = logging.getLogger("client")

PRECISION = 20  # bursts per second
BURST_INTERVAL = 1.0 / PRECISION
#: deficit catch-up cap, in nominal bursts: a slot that overran leaves a
#: deficit the next slots repay, but a long stall must not turn into one
#: giant burst — beyond this the backlog is forgiven (and the "rate too
#: high" contract line keeps the shortfall honest)
CATCHUP_BURSTS = 8


class _NodeConn:
    """One persistent framed connection; ACK frames are drained.

    A node dying MID-RUN must not kill the client (it feeds the whole
    committee — aborting on one peer's death starves every survivor of
    payloads and stalls consensus; found by the SIGKILL-rejoin e2e).
    Failures mark the connection dead; a background loop reconnects, so
    a restarted node starts receiving payloads again."""

    def __init__(self, address):
        self.address = address
        self.writer: asyncio.StreamWriter | None = None
        self._sink: asyncio.Task | None = None
        self.alive = False

    @staticmethod
    def _reap_orphaned_open(task: "asyncio.Task") -> None:
        """Close a connection whose open completed but whose result was
        dropped by cancellation (no owner will ever see it)."""
        if task.cancelled() or task.exception() is not None:
            return
        _, writer = task.result()
        writer.close()

    async def connect(self) -> None:
        # Cancellation-safe: the caller wraps this in wait_for.  The
        # leak window is the cancel landing AT the await when the open
        # has already completed — the task machinery drops the completed
        # (reader, writer) result, so nothing in this frame ever sees
        # the established transport.  Run the open as its own task and,
        # on cancellation, attach a reaper that closes the transport if
        # the open (has) succeeded; assign self.* only once fully set up.
        open_task = asyncio.ensure_future(
            asyncio.open_connection(*self.address)
        )
        try:
            reader, writer = await open_task
        except asyncio.CancelledError:
            open_task.add_done_callback(self._reap_orphaned_open)
            raise
        try:
            set_nodelay(writer)
            sink = asyncio.ensure_future(self._drain(reader))
        except BaseException:
            writer.close()
            raise
        self.writer = writer
        self._sink = sink
        self.alive = True

    def send_frame(self, message: bytes) -> None:
        if not self.alive:
            return
        try:
            write_frame(self.writer, message)
        except (ConnectionError, OSError):
            self.mark_dead()

    async def drain(self, timeout: float = 1.0) -> None:
        if not self.alive:
            return
        try:
            # a black-holed peer (partition, frozen process — no RST)
            # buffers writes silently until the transport's high-water
            # mark, then drain() would block for the full TCP timeout,
            # starving every LIVE peer of payloads — bound it
            await asyncio.wait_for(self.writer.drain(), timeout)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            self.mark_dead()

    def mark_dead(self) -> None:
        if self.alive:
            log.warning("Node %s:%d unreachable; dropping until it returns",
                        *self.address)
        self.alive = False
        self.close()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.cancel()
            self._sink = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    @staticmethod
    async def _drain(reader: asyncio.StreamReader) -> None:
        try:
            while True:
                await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass


async def wait_for_nodes(
    addresses, poll=0.1, timeout=15.0, expect_faults=0
) -> list:
    """Wait until nodes are listening; give up per-address after
    ``timeout`` so crash-faulted committees (reference local.py:75-76 —
    faulty nodes are simply never booted) don't stall the client.
    ``expect_faults`` is the number of nodes known to never boot: the
    early-start grace below only kicks in once the expected live count
    is reached, so a merely slow-booting node in a fault-free committee
    still gets the full ``timeout``.  Returns the reachable addresses."""
    up = []
    loop = asyncio.get_running_loop()
    last_join = loop.time()

    async def probe(address):
        nonlocal last_join
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            try:
                _, w = await asyncio.open_connection(*address)
                w.close()
                up.append(address)
                last_join = loop.time()
                return
            except OSError:
                await asyncio.sleep(poll)

    # Don't let crash-faulted (never-booted) nodes consume the whole
    # benchmark window: once the expected live count is up and no new
    # node has joined for ``grace`` seconds, start without the rest.
    grace = 2.0
    expected_live = max(1, len(addresses) - expect_faults)
    tasks = [asyncio.ensure_future(probe(a)) for a in addresses]
    deadline = loop.time() + timeout
    while loop.time() < deadline and not all(t.done() for t in tasks):
        await asyncio.sleep(poll)
        if len(up) >= expected_live and loop.time() - last_join > grace:
            break
    for t, a in zip(tasks, addresses):
        if not t.done():
            t.cancel()
            log.warning("Node %s:%d never came up; skipping", *a)
    return up


async def run_client(
    addresses,
    rate: int,
    duration: float,
    warmup: float = 0.0,
    expect_faults: int = 0,
    size: int = 512,
    homes: int = 1,
) -> int:
    """Send ``rate`` producer payloads/s for ``duration`` seconds,
    round-robining each payload to ``homes`` live nodes (see the
    comment at the send loop).  Returns the TOTAL number of payloads
    sent across all nodes.

    ``size``: payload BODY bytes per transaction (default 512, the
    reference's WAN tx size, data/2-chain/README.md:42-57) — the body
    rides the producer message and is stored by the ingest node, so the
    harness measures real byte throughput.  ``size=0`` sends bare
    digests (the fork's original digest-only producer contract).

    ``homes``: how many (consecutive round-robin) nodes receive each
    payload.  1 (default) keeps proposer queues disjoint — maximum
    block capacity, but a payload waits for ITS node's leader turn
    (~half a committee lap of e2e latency at large n).  2+ trades a
    bounded duplicate-proposal window (the proposers prune committed
    digests on every commit signal) for proportionally earlier
    proposal."""
    import os

    from ..consensus.wire import encode_producer

    log.info("Waiting for all nodes to be online...")
    # Boot time scales with committee size when many node processes share
    # few cores (each pays interpreter+import startup): give large
    # committees a proportionally longer grace window.
    boot_timeout = max(15.0, 3.0 * len(addresses))
    live = await wait_for_nodes(
        addresses, timeout=boot_timeout, expect_faults=expect_faults
    )
    if not live:
        log.error("No nodes reachable")
        return 0
    if warmup:
        await asyncio.sleep(warmup)

    conns = [_NodeConn(a) for a in live]
    for c in conns:
        try:
            await asyncio.wait_for(c.connect(), 2.0)
        except (OSError, asyncio.TimeoutError):
            # died between the port probe and here — the reconnector
            # keeps trying; one peer must never kill the whole client
            log.warning("Node %s:%d refused the connection; will retry",
                        *c.address)

    async def try_reconnect(c: _NodeConn) -> None:
        try:
            # bounded: a SYN-black-holing peer must not stall the
            # reconnection of OTHER dead peers for the OS connect timeout
            await asyncio.wait_for(c.connect(), 1.5)
            log.info("Reconnected to %s:%d", *c.address)
        except (OSError, asyncio.TimeoutError):
            pass

    async def reconnector() -> None:
        """Bring dead peers back (a restarted node must start receiving
        payloads again, or it can never propose when it leads)."""
        while True:
            await asyncio.sleep(2.0)
            dead = [c for c in conns if not c.alive]
            if dead:
                await asyncio.gather(*(try_reconnect(c) for c in dead))

    reconnect_task = asyncio.ensure_future(reconnector())

    burst = max(1, rate // PRECISION)
    log.info("Start sending transactions")
    # NOTE: these log entries are used to compute performance.
    log.info("Transactions rate: %d tx/s", rate)
    log.info("Transactions size: %d B", size)

    loop = asyncio.get_running_loop()
    start = loop.time()
    sent = 0
    forgiven = 0  # scheduled payloads written off (dead peers, cap)
    counter = 0
    was_all_dead = False
    try:
        while loop.time() - start < duration:
            slot_start = loop.time()
            # write the whole burst per connection without per-frame
            # drain syncs — one drain per (conn, burst) keeps the client
            # from becoming the bottleneck at large committees (each
            # drain is an await even when the buffer has room).  Send
            # errors mark THAT connection dead (handled inside
            # _NodeConn); the burst continues to the rest.
            # Round-robin each payload to ``homes`` live nodes
            # (default 1: the reference runs one client per node feeding
            # only it, local.py:79-91; this is the single-client
            # equivalent).  Broadcasting every payload to EVERY node
            # makes all proposer queues identical, so concurrent leaders
            # fill blocks with the same digests — measured 3/4 of
            # committed-block capacity wasted on duplicates at 4 nodes;
            # homes=2 measured strictly worse on a one-core host too
            # (docs/ROUND4.md).  With homes=1 queues are disjoint and
            # every block slot unique; orphaned proposals are
            # re-buffered by the proposer (orphan recovery), so
            # single-homing is safe.
            live = [c for c in conns if c.alive]
            # Open-loop integrity: the slot's send count derives from
            # the wall clock, not a fixed quantum — a slot that overran
            # its interval leaves a deficit the following slots repay,
            # so the delivered rate tracks the offered rate instead of
            # silently sagging every time a burst ran long.
            expected = int((slot_start - start) * rate) + burst
            target = expected - sent - forgiven
            if not live:
                # with zero live peers nothing is transmitted: neither
                # the sent counter nor the sample log line may claim
                # otherwise (the harness counts both) — forgive the
                # backlog rather than bursting it all on reconnect
                forgiven += target
                target = 0
            capped = target > burst * CATCHUP_BURSTS
            if capped:
                forgiven += target - burst * CATCHUP_BURSTS
                target = burst * CATCHUP_BURSTS
            for i in range(max(0, target)):
                if size > 0:
                    # real transaction bytes, content-addressed: the
                    # counter makes every body unique (reference
                    # client.rs:103-133 tags bodies with a counter too)
                    body = sent.to_bytes(8, "big") + os.urandom(
                        max(0, size - 8)
                    )
                    digest = Digest.of(body)
                else:
                    body = b""
                    digest = Digest.random()
                if i == 0:
                    # NOTE: this log entry is used to compute performance.
                    log.info("Sending sample payload %s", digest)
                frame = encode_producer(digest, body)
                for h in range(min(homes, len(live))):
                    live[(sent + h) % len(live)].send_frame(frame)
                sent += 1
            for c in conns:
                await c.drain()
            all_dead = not any(c.alive for c in conns)
            if all_dead and not was_all_dead:
                log.warning("Every node unreachable; waiting to reconnect")
            was_all_dead = all_dead
            counter += 1
            elapsed = loop.time() - slot_start
            if capped or elapsed > BURST_INTERVAL:
                # NOTE: this log entry is used to compute performance.
                log.warning("Transaction rate too high for this client")
            if elapsed < BURST_INTERVAL:
                await asyncio.sleep(BURST_INTERVAL - elapsed)
    finally:
        reconnect_task.cancel()
        for c in conns:
            c.close()
    window = loop.time() - start
    if window > 0:
        # NOTE: this log entry is used to compute performance.
        log.info(
            "Delivered rate: %d tx/s (%d payloads in %.1f s)",
            round(sent / window), sent, window,
        )
    return sent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Producer-path benchmark client"
    )
    parser.add_argument(
        "--committee", required=True, help="committee JSON file"
    )
    parser.add_argument("--rate", type=int, default=1_000, help="payloads/s")
    parser.add_argument(
        "--size",
        type=int,
        default=512,
        help="payload body bytes (0 = digest-only producer contract)",
    )
    parser.add_argument(
        "--homes",
        type=int,
        default=1,
        help="nodes receiving each payload (1 = disjoint queues; more "
        "trades duplicate-proposal slack for earlier proposal)",
    )
    parser.add_argument(
        "--duration", type=float, default=20.0, help="send window (s)"
    )
    parser.add_argument(
        "--warmup", type=float, default=2.0, help="settle time after ports open"
    )
    parser.add_argument(
        "--faults",
        type=int,
        default=0,
        help="nodes known to be crash-faulted (never booted)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=1)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=[logging.ERROR, logging.INFO, logging.DEBUG][min(args.verbose, 2)],
        format="%(asctime)s.%(msecs)03dZ [%(levelname)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )

    from ..consensus.wire import MAX_PAYLOAD_BODY

    if args.homes < 1:
        # fail FAST: homes=0 would count and sample-log payloads that
        # never hit the wire, reporting a silent zero-commit run
        parser.error("--homes must be >= 1")
    if not 0 <= args.size <= MAX_PAYLOAD_BODY:
        # fail FAST: an oversized body would be dropped by every node's
        # wire decoder and the run would silently report zero commits
        parser.error(
            f"--size must be in [0, {MAX_PAYLOAD_BODY}] "
            "(the wire decoder's payload-body cap)"
        )
    if 0 < args.size < 8:
        # the body always carries the 8-byte uniqueness counter, so a
        # 1..7-byte request would silently send 8-byte bodies while the
        # harness reports BPS from the requested size — refuse the
        # misreporting configuration instead
        parser.error("--size must be 0 (digest-only) or >= 8 (counter width)")
    committee = read_committee(args.committee)
    addresses = [a.address for a in committee.authorities.values()]
    sent = asyncio.run(
        run_client(
            addresses,
            args.rate,
            args.duration,
            args.warmup,
            expect_faults=args.faults,
            size=args.size,
            homes=args.homes,
        )
    )
    log.info("Sent %d payloads", sent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
