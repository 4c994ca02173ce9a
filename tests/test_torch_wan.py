"""The port's WAN link model (``network/wan.py``) and ``lucky_broadcast``
against the JAX package's:

- ``build_spec`` over the same 64 addresses, equal dicts;
- ``WanModel.delay`` for every ordered pair of the five regions (and an
  unknown peer), float for float after the same ``random.seed``;
- a malformed or missing spec raises the same error in both packages,
  and ``Consensus.spawn`` raises on it (no quiet fall back);
- ``LinkScheduler``: deliver-at times clamped FIFO and pipelined, never
  a rate limit;
- the simple sender delays delivery by at least the link's delay, the
  reliable sender's ACK future resolves after the full round trip;
- ``lucky_broadcast`` in the three senders that have it (asyncio simple
  and reliable, native simple) picks the same peers as the JAX one under
  the same seed and delivers to ``min(nodes, len(addresses))`` of them;
- a 4-node port committee on the WAN model commits, with a mean commit
  latency above two of its leader's one-way hops.

Every listener port comes from the OS; every wait has a deadline;
every receiver, sender and stack is stopped in ``finally``."""

import asyncio
import json
import os
import random
import time

import pytest
import torch

from hotstuff_tpu.network import ReliableSender as JReliableSender
from hotstuff_tpu.network import SimpleSender as JSimpleSender
from hotstuff_tpu.network import wan as jwan
from hotstuff_tpu_torch.bench.committee import reserve_ports, run_committee
from hotstuff_tpu_torch.network import Receiver, ReliableSender, SimpleSender, native, wan

from .test_torch_network import listener

SEED = 20_261_017
TIMEOUT_S = 10.0
torch.set_num_threads(1)

ADDRS_64 = [("127.0.0.1", 30_000 + 7 * i) for i in range(64)]


def test_build_spec_over_64_addresses_equals_jax():
    spec = wan.build_spec(ADDRS_64)
    assert spec == jwan.build_spec(ADDRS_64)
    assert json.dumps(spec) == json.dumps(jwan.build_spec(ADDRS_64))
    counts = {r: list(spec["regions"].values()).count(r) for r in wan.DEFAULT_REGIONS}
    assert sorted(counts.values()) == [12, 13, 13, 13, 13]
    assert wan.DEFAULT_REGIONS == jwan.DEFAULT_REGIONS
    assert wan.DEFAULT_MATRIX == jwan.DEFAULT_MATRIX


def test_delay_for_every_region_pair_equals_jax_after_the_same_seed():
    spec = wan.build_spec(ADDRS_64)
    firsts = ADDRS_64[:5]  # one address a region, round robin
    unknown = ("10.9.9.9", 1)

    def draws(mod) -> list:
        random.seed(SEED)
        out = []
        for src in firsts:
            model = mod.WanModel(spec, src)
            for dst in firsts + [unknown]:
                out += [model.delay(dst) for _ in range(16)]
        return out

    port, ref = draws(wan), draws(jwan)
    assert port == ref
    assert all(d >= 0.0 for d in port)
    m = wan.WanModel({**spec, "jitter_pct": 0.0}, firsts[0])  # us-east-1
    assert m.self_region == "us-east-1"
    assert m.delay(firsts[1]) == 0.055 and m.delay(firsts[3]) == 0.030
    assert m.delay(ADDRS_64[5]) == 0.0005  # the same region
    assert m.delay(unknown) == 0.0


@pytest.mark.parametrize("content, error", [
    (None, FileNotFoundError),
    ("{not json", json.JSONDecodeError),
    ('{"matrix_one_way_ms": {}}', KeyError),
    ('{"regions": {}, "matrix_one_way_ms": {"a": 1}}', ValueError),
], ids=["missing", "not-json", "no-regions", "bad-pair"])
def test_a_bad_spec_raises_as_in_jax(tmp_path, content, error):
    path = tmp_path / "wan.json"
    if content is not None:
        path.write_text(content)
    for mod in (wan, jwan):
        with pytest.raises(error):
            mod.WanModel.load(str(path), ADDRS_64[0])


def test_spawn_raises_on_an_unreadable_spec(tmp_path, monkeypatch):
    """``HOTSTUFF_WAN_SPEC`` naming a missing file stops the node's boot
    on the asyncio transport; nothing runs without the plane."""
    monkeypatch.setenv("HOTSTUFF_WAN_SPEC", str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        run_committee(nodes=4, rate=10, duration=1, verifier="cpu")


def test_link_scheduler_pipelines_and_clamps_fifo():
    """Ten messages entering back to back all deliver ~one delay later,
    never ten delays (propagation, not a token bucket), and a shorter
    draw after a longer one is clamped so the link never reorders."""

    async def body():
        loop = asyncio.get_running_loop()
        sched = wan.LinkScheduler(lambda: 0.05)
        t0 = loop.time()
        ats = [sched.deliver_at() for _ in range(10)]
        assert all(a >= t0 + 0.049 for a in ats)
        assert ats == sorted(ats) and ats[-1] - ats[0] < 0.01
        await wan.LinkScheduler.wait_until(ats[-1])
        assert loop.time() >= ats[-1] - 1e-4
        draws = iter([0.3, 0.01, 0.2, 0.0])
        clamp = wan.LinkScheduler(lambda: next(draws))
        got = [clamp.deliver_at() for _ in range(4)]
        assert got == sorted(got) and got[1] == got[0] and got[3] >= got[2]

    asyncio.run(body())


def test_simple_sender_delays_delivery_by_the_links_delay():
    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        served = asyncio.ensure_future(listener(sock, b"delayed hello"))
        sender = SimpleSender(link_delay=lambda addr: (lambda: 0.2))
        try:
            t0 = time.perf_counter()
            await sender.send(("127.0.0.1", port), b"delayed hello")
            await asyncio.wait_for(served, TIMEOUT_S)
            return time.perf_counter() - t0
        finally:
            sender.close()
            served.cancel()

    elapsed = asyncio.run(body())
    assert elapsed >= 0.19, f"the frame arrived after only {elapsed * 1e3:.0f} ms"


def test_reliable_sender_ack_sees_the_full_round_trip():
    async def body():
        (sock,) = reserve_ports(1)
        port = sock.getsockname()[1]
        served = asyncio.ensure_future(listener(sock, b"ping"))
        sender = ReliableSender(link_delay=lambda addr: (lambda: 0.1))
        try:
            t0 = time.perf_counter()
            handle = await sender.send(("127.0.0.1", port), b"ping")
            ack = await asyncio.wait_for(handle, TIMEOUT_S)
            return ack, time.perf_counter() - t0
        finally:
            sender.close()
            served.cancel()

    ack, rtt = asyncio.run(body())
    assert ack == b"Ack"
    # the outbound leg (100 ms) and the ACK's return leg (100 ms)
    assert rtt >= 0.19, f"the ACK resolved after only {rtt * 1e3:.0f} ms"


# ---- lucky_broadcast ---------------------------------------------------------


class _Count:
    def __init__(self):
        self.frames: list = []

    async def dispatch(self, writer, message: bytes) -> None:
        self.frames.append(message)
        await writer.send(b"Ack")


def _jax_picks(kind: str, addresses, nodes: int, seed: int) -> list:
    """The JAX sender's picks under ``random.seed(seed)``, captured where
    its ``lucky_broadcast`` hands them on."""
    picks: list = []

    async def body():
        if kind == "native":
            jnative = pytest.importorskip("hotstuff_tpu.network.native")
            sender = object.__new__(jnative.NativeSimpleSender)
            sender._flows = None

            async def dispatch(address, payload):
                picks.append(address)

            sender._dispatch = dispatch
        else:
            sender = (JSimpleSender if kind == "simple" else JReliableSender)()

            async def broadcast(addresses, data):
                picks.extend(addresses)
                return []

            sender.broadcast = broadcast
        random.seed(seed)
        await sender.lucky_broadcast(list(addresses), b"\x01lucky", nodes)

    asyncio.run(body())
    return picks


@pytest.mark.parametrize("nodes", [3, 9], ids=["3-of-6", "9-of-6"])
@pytest.mark.parametrize("kind", ["simple", "reliable", "native"])
def test_lucky_broadcast_picks_as_jax_and_reaches_that_many_peers(kind, nodes):
    peers = 6

    async def body():
        socks = reserve_ports(peers)
        addresses = [("127.0.0.1", s.getsockname()[1]) for s in socks]
        for s in socks:
            s.close()
        handlers = [_Count() for _ in addresses]
        receiver_cls = native.NativeReceiver if kind == "native" else Receiver
        recvs = [receiver_cls(h, p, x) for (h, p), x in zip(addresses, handlers)]
        sender = None
        try:
            for r in recvs:
                await r.spawn()
            sender = {"simple": SimpleSender, "reliable": ReliableSender,
                      "native": native.NativeSimpleSender}[kind]()
            random.seed(SEED)
            got = await sender.lucky_broadcast(list(addresses), b"\x01lucky", nodes)
            if kind == "reliable":
                await asyncio.wait_for(asyncio.gather(*got), TIMEOUT_S)
            want = min(nodes, peers)
            deadline = asyncio.get_running_loop().time() + TIMEOUT_S
            while sum(len(h.frames) for h in handlers) < want:
                assert asyncio.get_running_loop().time() < deadline, "lucky frames"
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)  # nothing beyond the picks arrives
            return addresses, [a for a, h in zip(addresses, handlers) if h.frames]
        finally:
            if sender is not None:
                sender.close()
            for r in recvs:
                await r.shutdown()

    addresses, reached = asyncio.run(body())
    picks = _jax_picks(kind, addresses, nodes, SEED)
    assert len(picks) == len(set(picks)) == min(nodes, peers)
    assert sorted(reached) == sorted(picks)
    random.seed(SEED)
    assert picks == random.sample(addresses, min(nodes, peers))


# ---- a committee on the WAN model --------------------------------------------


def test_port_committee_commits_on_the_wan_model(monkeypatch):
    """Four port nodes with ``run_committee(..., wan=True)``: a region a
    node (four of the five), the environment restored after the run, and
    commits whose mean latency is above two one-way hops between the
    closest regions of the committee (us-east-1 to us-west-1, 30 ms)."""
    monkeypatch.delenv("HOTSTUFF_WAN_SPEC", raising=False)
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    r = run_committee(nodes=4, rate=100, duration=4, verifier="cuda", device="cpu", wan=True)
    assert r["wan_regions"] == {region: 1 for region in wan.DEFAULT_REGIONS[:4]}
    assert min(r["blocks"]) >= 2 and r["chains_agree"]
    assert r["latency_mean_s"] is not None and r["latency_mean_s"] > 2 * 0.030
    assert "HOTSTUFF_WAN_SPEC" not in os.environ
