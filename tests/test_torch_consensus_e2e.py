"""Full-committee end-to-end tests of the port: four consensus stacks on
localhost committing one chain, three of four committing through the
timeout/TC path, a node stopped and restarted from its store catching
up from a peer's snapshot, a mixed committee of two JAX and two port
nodes in one event loop agreeing on one chain and on its state roots,
and ``run_committee`` committing through producer frames on the CUDA
kind's host (``device="cpu"``), with and without a crash and recovery.

Every listener port comes from the OS (``reserve_ports``); every wait
has a deadline; every stack and store is shut down in ``finally``."""

import asyncio

import torch

from benchmark.invariants import check_state_root_agreement
from benchmark.logs import RE_STATE_ROOT

from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee

from .test_torch_core import JAX, PORT, _Lines

TIMEOUT_S = 30.0
# the plain versions run on the CPU here; one thread keeps them off the
# cores the other test workers use
torch.set_num_threads(1)


async def _spawn_one(side, tmp_path, i, ports, timeout_delay, sync_retry_delay):
    """Node i of ``side`` on its store under ``tmp_path``."""
    name, secret = side.keys()[i]
    store = side.store.Store(str(tmp_path / f"db_{i}"))
    commit_q: asyncio.Queue = asyncio.Queue()
    try:
        stack = await side.consensus.Consensus.spawn(
            name,
            side.committee(ports),
            side.consensus.Parameters(
                timeout_delay=timeout_delay, sync_retry_delay=sync_retry_delay
            ),
            side.crypto.SignatureService(secret),
            store,
            commit_q,
            bind_host="127.0.0.1",
        )
    except BaseException:
        store.close()
        raise
    return side, stack, commit_q, store


async def _spawn(sides, tmp_path, indices, timeout_delay=1_000, sync_retry_delay=5_000, ports=None):
    """One stack per index, node i on ``sides[i]`` (a package), all in
    this event loop; each listener's port reserved, then freed just
    before its stack binds it (``ports``, when given, receives them)."""
    socks = reserve_ports(4)
    reserved = [s.getsockname()[1] for s in socks]
    if ports is not None:
        ports += reserved
    nodes = []
    try:
        for i in indices:
            socks[i].close()
            nodes.append(await _spawn_one(
                sides[i], tmp_path, i, reserved, timeout_delay, sync_retry_delay
            ))
    except BaseException:
        await _shutdown(nodes, None)
        raise
    finally:
        for s in socks:
            s.close()
    return nodes


async def _feed_producers(nodes, interval=0.02):
    i = 0
    while True:
        i += 1
        for side, stack, _, _ in nodes:
            await stack.tx_producer.put(side.crypto.Digest.of(b"e2e payload %d" % i))
        await asyncio.sleep(interval)


async def _shutdown(nodes, feeder):
    if feeder is not None:
        feeder.cancel()
    for _, stack, _, _ in nodes:
        await stack.shutdown()
    for _, _, _, store in nodes:
        store.close()


async def _commits(commit_q, count):
    """The next ``count`` committed non-genesis blocks' (round, digest)."""
    out = []
    while len(out) < count:
        block = await asyncio.wait_for(commit_q.get(), timeout=TIMEOUT_S)
        if block.round > 0:
            out.append((block.round, block.digest().to_bytes()))
    return out


def _assert_one_chain(chains):
    for chain in chains:
        rounds = [r for r, _ in chain]
        assert rounds == sorted(rounds) and len(set(rounds)) == len(rounds)
    common = min(map(len, chains))
    assert common > 0
    for chain in chains[1:]:
        assert chain[:common] == chains[0][:common]


def test_port_committee_all_nodes_commit(tmp_path):
    async def body():
        nodes = await _spawn([PORT] * 4, tmp_path, range(4))
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        try:
            _assert_one_chain([await _commits(q, 3) for _, _, q, _ in nodes])
        finally:
            await _shutdown(nodes, feeder)

    asyncio.run(body())


def test_port_committee_one_crash_fault(tmp_path):
    """3 of 4 nodes reach quorum (2f+1 = 3) and commit, riding the
    timeout/TC view change whenever the absent node leads a round."""

    async def body():
        nodes = await _spawn([PORT] * 4, tmp_path, [0, 1, 2], timeout_delay=500)
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        try:
            chains = [await _commits(q, 4) for _, _, q, _ in nodes]
            _assert_one_chain(chains)
            assert sum(stack.core.local_timeouts for _, stack, _, _ in nodes) > 0
        finally:
            await _shutdown(nodes, feeder)

    asyncio.run(body())


def test_mixed_committee_of_jax_and_port_nodes(tmp_path):
    """Two JAX nodes and two port nodes in one event loop: the packages
    exchange proposals, votes and certificates on the wire and commit
    one chain."""

    async def body():
        nodes = await _spawn([JAX, PORT, JAX, PORT], tmp_path, range(4))
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        try:
            _assert_one_chain([await _commits(q, 12) for _, _, q, _ in nodes])
        finally:
            await _shutdown(nodes, feeder)

    asyncio.run(body())


def test_run_committee_commits_through_producer_frames(monkeypatch):
    """``run_committee`` on the CUDA kind's host, run on the CPU: four
    nodes share one ``make_verifier("cuda", device="cpu")`` and its wave
    service and commit the producer frames a TCP client sends.  The
    kernels' plain versions take seconds a wave on the CPU, so routing
    is held to the CPU here and the warm-up covers one bucket; the card
    drives the device route (``chip_smoke.py`` phase (c))."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    r = run_committee(nodes=4, rate=200, duration=3, verifier="cuda", device="cpu")
    assert r["device"] == "cpu" and r["quorum"] == 3
    assert r["sent"] >= 500
    assert min(r["blocks"]) >= 5
    assert r["chains_agree"] and r["common_prefix"] >= 5
    assert r["committed_payloads"] > 0 and r["payloads_per_s"] > 0
    assert 0 < r["latency_p50_s"] < 3 and r["latency_mean_s"] > 0
    svc = r["service"]
    assert svc["cpu"] > 0 and svc["device"] == 0 and svc["cpu_sigs"] > 0
    assert r["k1_launches"] == 0 and r["max_loop_lag_s"] >= 0
    assert r["boot_s"] > 0 and r["shutdown_s"] > 0


def _node_lines(sides) -> _Lines:
    """The core and state-sync log lines of every node (node i on
    ``sides[i]``)."""
    return _Lines(*(
        f"{side.root}.consensus.{module}.{str(side.keys()[i][0])[:8]}"
        for i, side in enumerate(sides) for module in ("core", "statesync")
    ))


def _roots(lines: _Lines) -> dict:
    """Per node, ``(version, root, round)`` from its ``State root`` lines
    (the schema of benchmark.invariants)."""
    out: dict = {}
    for name, node_lines in lines.lines.items():
        tag = name.rsplit(".", 1)[1]
        out.setdefault(tag, []).extend(
            (int(v), root, int(r))
            for line in node_lines for _, v, root, r in RE_STATE_ROOT.findall(line)
        )
    return out


async def _wait(cond, what: str, limit_s: float = TIMEOUT_S) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + limit_s
    while not cond():
        assert loop.time() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


def test_port_node_restarts_and_catches_up_from_a_snapshot(tmp_path, monkeypatch):
    """Node 3 of a port committee is stopped hard (tasks, listener,
    sockets, store) while the others commit on, timing out its leader
    turns; spawned again on its store, it adopts a peer's certified
    snapshot, logs the advance of its commit cursor past the outage,
    commits new blocks, and every node's state roots agree at every
    version (benchmark.invariants)."""
    monkeypatch.setenv("HOTSTUFF_STATE_SYNC_LAG", "2")
    logs = _node_lines([PORT] * 4)

    async def body():
        ports: list[int] = []
        nodes = await _spawn([PORT] * 4, tmp_path, range(4), timeout_delay=300,
                             sync_retry_delay=300, ports=ports)
        feeder = asyncio.ensure_future(_feed_producers(nodes, interval=0.05))
        down = None
        try:
            await _commits(nodes[3][2], 3)
            side, down, _, store = nodes[3]
            await down.shutdown()
            store.close()
            cursor = down.core.last_committed_round
            live = [stack for _, stack, _, _ in nodes[:3]]
            timeouts = sum(s.core.local_timeouts for s in live)
            await _wait(lambda: max(s.core.last_committed_round for s in live) >= cursor + 8,
                        "the live nodes to commit past the stopped node")
            assert sum(s.core.local_timeouts for s in live) > timeouts
            nodes[3] = await _spawn_one(PORT, tmp_path, 3, ports, 300, 300)
            down = None
            restarted = nodes[3][1]
            assert restarted.core.state_sync is not None
            assert len(await _commits(nodes[3][2], 3)) == 3
            outcome = restarted.core.state_sync.outcome
            assert outcome["adopted"] and outcome["kind"] == "delta"
            assert outcome["round"] >= cursor + 2 and outcome["entries"] > 0
        finally:
            await _shutdown([n for n in nodes if n[1] is not down], feeder)

    try:
        asyncio.run(body())
        tag = str(PORT.keys()[3][0])[:8]
        assert any("Adopted state snapshot version" in line
                   for line in logs.lines[f"hotstuff_tpu_torch.consensus.statesync.{tag}"])
        assert any("State sync advanced commit cursor" in line
                   for line in logs.lines[f"hotstuff_tpu_torch.consensus.core.{tag}"])
        ok, violations, details = check_state_root_agreement(_roots(logs))
        assert ok is True, violations
        assert details["nodes_reporting"] == 4
    finally:
        logs.close()


def test_mixed_committee_agrees_on_state_roots(tmp_path):
    """Two JAX nodes and two port nodes apply the same commits to their
    execution layers: every version's state root is the same in both
    packages (benchmark.invariants)."""
    sides = [JAX, PORT, JAX, PORT]
    logs = _node_lines(sides)

    async def body():
        nodes = await _spawn(sides, tmp_path, range(4))
        feeder = asyncio.ensure_future(_feed_producers(nodes))
        try:
            for _, _, q, _ in nodes:
                await _commits(q, 6)
        finally:
            await _shutdown(nodes, feeder)

    try:
        asyncio.run(body())
        roots = _roots(logs)
        ok, violations, details = check_state_root_agreement(roots)
        assert ok is True, violations
        assert details["nodes_reporting"] == 4 and details["versions_compared"] >= 6
        by_package = [{v: root for v, root, _ in roots[str(s.keys()[i][0])[:8]]} for i, s in enumerate(sides)]
        shared = set(by_package[0]) & set(by_package[1])
        assert len(shared) >= 6 and all(by_package[0][v] == by_package[1][v] for v in shared)
    finally:
        logs.close()


def test_run_committee_restart_catches_up_on_cpu(monkeypatch):
    """``run_committee`` with a crash and recovery on the CUDA kind's
    host, run on the CPU (routing held to the CPU, as above): the node
    stopped 1 s into the load is spawned again once the others are 16
    rounds past it, adopts a delta snapshot at least 8 rounds past its
    cursor, logs the cursor's advance, and every ledger read of a
    payload committed while it was down matches a live node's."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    r = run_committee(
        nodes=4, rate=200, duration=5, verifier="cuda", device="cpu", timeout_delay=200,
        restart={"node": 1, "down_at_s": 1.0, "behind_rounds": 16, "deadline_s": 4.0},
    )
    sync = r["state_sync"]
    assert sync["adopted"] and sync["kind"] == "delta" and sync["entries"] > 0
    assert sync["rounds_behind"] >= 16 and sync["round"] >= sync["cursor_at_stop"] + 8
    assert sync["cursor_advanced"] == (sync["cursor_at_stop"], sync["round"])
    # every peer offers unless the 1 s manifest window closes first; each
    # distinct anchoring QC is checked once, below the device threshold
    assert 1 <= sync["offers"] <= 3 and sync["chunks"] >= 1 and sync["sync_s"] > 0
    routes = sync["qc_check_routes"]
    assert routes["device"] == 0 and 1 <= routes["cpu"] <= sync["offers"]
    assert r["chains_agree"] and r["roots_agree"]
    assert min(r["blocks"]) >= 5 and r["timeouts"] > 0
    assert len(r["state_roots"]) == 4 and all(r["state_roots"])
    reads = r["ledger_reads"]
    assert reads["reads"] > 0 and reads["found"] == reads["matched"] == reads["reads"]
