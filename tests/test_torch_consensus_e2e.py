"""Full-committee end-to-end tests of the port: four consensus stacks on
localhost committing one chain, three of four committing through the
timeout/TC path, a mixed committee of two JAX and two port nodes in one
event loop agreeing on one chain, and ``run_committee`` committing
through producer frames on the CUDA kind's host (``device="cpu"``).

Every listener port comes from the OS (``reserve_ports``); every wait
has a deadline; every stack and store is shut down in ``finally``."""

import asyncio

import torch

from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee

from .test_torch_core import JAX, PORT

TIMEOUT_S = 30.0
# the plain versions run on the CPU here; one thread keeps them off the
# cores the other test workers use
torch.set_num_threads(1)


async def _spawn(sides, tmp_path, indices, timeout_delay=1_000):
    """One stack per index, node i on ``sides[i]`` (a package), all in
    this event loop; each listener's port reserved, then freed just
    before its stack binds it."""
    socks = reserve_ports(4)
    ports = [s.getsockname()[1] for s in socks]
    nodes = []
    try:
        for i in indices:
            side = sides[i]
            name, secret = side.keys()[i]
            store = side.store.Store(str(tmp_path / f"db_{i}"))
            commit_q: asyncio.Queue = asyncio.Queue()
            socks[i].close()
            stack = await side.consensus.Consensus.spawn(
                name,
                side.committee(ports),
                side.consensus.Parameters(timeout_delay=timeout_delay, sync_retry_delay=5_000),
                side.crypto.SignatureService(secret),
                store,
                commit_q,
                bind_host="127.0.0.1",
            )
            nodes.append((side, stack, commit_q, store))
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
