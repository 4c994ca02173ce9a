"""The port's state sync against the JAX package's: a snapshot served by
one package and fetched over TCP by the other (full and delta, both
ways) installs the server's cursor and entries byte for byte; a chunk
ask that is dropped is asked again; both packages reject the same bad
offers; and the certified schedule-link walk, the counterparts of
tests/test_reconfig.py's splice tests, on both packages.

Every listener port comes from the OS (``reserve_ports``); every wait
has a deadline; every actor, receiver and store is shut down in
``finally``."""

import asyncio
import importlib

import pytest

from hotstuff_tpu_torch.bench.committee import reserve_ports

from .test_torch_core import JAX, PORT, SEED
from .test_torch_state import _state_items

CHAIN = 12
MIN_LAG = 2
WAIT_S = 10.0


def _mods(side):
    mod = lambda name: importlib.import_module(f"{side.root}.{name}")  # noqa: E731
    return mod("store.state"), mod("consensus.statesync"), mod("consensus.wire")


def _typed(side, ops) -> bytes:
    state, _, _ = _mods(side)
    return bytes(state.OP_BODY_OFFSET) + state.encode_ops(ops)


class _DropFirstChunkAsk(asyncio.Queue):
    """A server's request queue that loses the first chunk ask, as a
    faulty link would."""

    dropped = 0

    async def put(self, item) -> None:
        if item.kind == 1 and not self.dropped:  # STATE_REQ_CHUNK
            self.dropped += 1
            return
        await super().put(item)


async def _serve(side, tmp_path, com, port, requests):
    """Node 0 of ``side``: the chain applied to its state machine (typed
    bodies for two blocks past the delta cut), a receiver routing state
    requests to a ``StateSyncServer`` anchored by the chain's last QC."""
    state, statesync, _ = _mods(side)
    blocks = side.chain(CHAIN)
    store = side.store.Store(str(tmp_path / f"server-{side.root}"))
    for i, ops in ((6, [("put", b"k1", b"v1"), ("put", b"k2", b"v2")]), (9, [("del", b"k1")])):
        store.engine.put(b"p" + blocks[i].payloads[0].to_bytes(), _typed(side, ops))
    sm = state.StateMachine(store)
    for b in blocks:
        sm.apply_block(b)
    qc = side.qc_for_block(blocks[-1])
    name = side.keys()[0][0]
    handler = side.consensus.ConsensusReceiverHandler(
        asyncio.Queue(), asyncio.Queue(), asyncio.Queue(),
        tx_state_requests=requests, state=sm,
    )
    receiver = side.network.Receiver("127.0.0.1", port, handler)
    server = statesync.StateSyncServer(
        name, com, sm, rx_requests=requests, high_qc=lambda: qc,
        network=side.network.SimpleSender(),
    )
    return blocks, store, sm, receiver, server


async def _sync(server_side, client_side, tmp_path, delta: bool, requests=None):
    """Node 3 of ``client_side`` boots (with the chain's first 4 blocks
    applied when ``delta``) and catches up from node 0 of
    ``server_side``; nodes 1 and 2 are down.  Returns what both hold."""
    socks = reserve_ports(4)
    ports = [s.getsockname()[1] for s in socks]
    com = client_side.committee(ports)
    requests = requests if requests is not None else asyncio.Queue()
    parts = []
    try:
        socks[0].close()
        blocks, s_store, s_sm, s_recv, server = await _serve(
            server_side, tmp_path, server_side.committee(ports), ports[0], requests
        )
        parts += [s_store.close, server.shutdown]
        await s_recv.spawn()
        parts.append(s_recv.shutdown)
        server.spawn()

        state, statesync, _ = _mods(client_side)
        c_store = client_side.store.Store(str(tmp_path / f"client-{client_side.root}"))
        parts.append(c_store.close)
        c_sm = state.StateMachine(c_store)
        for b in client_side.chain(4 if delta else 0):
            c_sm.apply_block(b)
        replies: asyncio.Queue = asyncio.Queue()
        handler = client_side.consensus.ConsensusReceiverHandler(
            asyncio.Queue(), asyncio.Queue(), asyncio.Queue(),
            tx_state_sync=replies, state=c_sm,
        )
        socks[3].close()
        c_recv = client_side.network.Receiver("127.0.0.1", ports[3], handler)
        await c_recv.spawn()
        parts.append(c_recv.shutdown)
        client = statesync.StateSyncClient(
            client_side.keys()[3][0], com, c_sm, client_side.service.CpuVerifier(),
            rx_replies=replies, network=client_side.network.SimpleSender(),
            min_lag=MIN_LAG, manifest_wait_s=0.5,
        )
        parts.append(client.network.close)
        adopted = await asyncio.wait_for(client.bootstrap(c_sm.last_round), WAIT_S)
        return {
            "adopted": adopted,
            "server": (s_sm.anchor(), _state_items(s_store.engine)),
            "client": (c_sm.anchor(), _state_items(c_store.engine)),
            "served": s_sm.snapshots_served,
            "outcome": getattr(client, "outcome", None),
            "delta_entries": len(s_sm._entries(4 if delta else 0)),
        }
    finally:
        for close in reversed(parts):
            out = close()
            if asyncio.iscoroutine(out):
                await out
        for s in socks:
            s.close()


@pytest.mark.parametrize("delta", [False, True], ids=["full", "delta"])
@pytest.mark.parametrize("server,client", [(PORT, JAX), (JAX, PORT)], ids=["port-serves-jax", "jax-serves-port"])
def test_snapshot_sync_across_packages(tmp_path, server, client, delta):
    """A client of one package adopts the other package's snapshot over
    TCP: the adopted round is the server's, and the client's cursor
    (version, root, last round) and every state entry equal the
    server's byte for byte."""
    r = asyncio.run(_sync(server, client, tmp_path, delta))
    assert r["adopted"] == CHAIN
    assert r["client"] == r["server"]
    assert r["server"][0][0] == CHAIN and len(r["server"][1]) > CHAIN
    assert r["served"] == 1
    if client is PORT:
        o = r["outcome"]
        assert o["adopted"] and o["kind"] == ("delta" if delta else "full")
        assert (o["offers"], o["version"], o["round"], o["reasks"]) == (1, CHAIN, CHAIN, 0)
        assert o["entries"] == r["delta_entries"] and o["chunk_count"] == 1


@pytest.mark.parametrize("client", [PORT, JAX], ids=["port", "jax"])
def test_dropped_chunk_ask_is_asked_again(tmp_path, client):
    """The server's link loses the first chunk ask: the client asks again
    after its re-ask period and completes the same adoption."""
    requests = _DropFirstChunkAsk()
    r = asyncio.run(_sync(PORT, client, tmp_path, delta=True, requests=requests))
    assert requests.dropped == 1
    assert r["adopted"] == CHAIN and r["client"] == r["server"]
    if client is PORT:
        assert r["outcome"]["reasks"] >= 1


def _offers(side, tmp_path) -> tuple:
    """One client's verdicts (``_acceptable``) on a set of offers built
    from the same seed: a good one, and one each with a sub-quorum QC, a
    QC older than the offered cursor, an unknown origin, the genesis QC,
    a version not ahead of the client's, and a cursor within the lag."""
    _, statesync, wire = _mods(side)
    c = side.consensus
    ks = side.keys()
    blocks = side.chain(CHAIN)
    qc = side.qc_for_block(blocks[-1])
    weak = side.qc_for_block(blocks[-1], voters=2)
    stranger = side.crypto.generate_keypair(SEED, 9)[0]

    def offer(version=CHAIN, last_round=CHAIN, qc=qc, origin=ks[0][0]):
        frame = wire.encode_state_manifest(version, bytes(32), last_round, 5, 1, 0, qc, origin)
        return wire.decode_message(frame)[1]

    async def judge():
        store = side.store.Store(str(tmp_path / f"judge-{side.root}"))
        try:
            sm = _mods(side)[0].StateMachine(store)
            sm.apply_block(blocks[0])
            client = statesync.StateSyncClient(
                ks[3][0], side.committee([1, 2, 3, 4]), sm, side.service.CpuVerifier(),
                rx_replies=asyncio.Queue(), min_lag=MIN_LAG, manifest_wait_s=0.1,
            )
            cases = [
                offer(),
                offer(qc=weak),
                offer(last_round=CHAIN + 1),
                offer(origin=stranger),
                offer(qc=c.QC.genesis()),
                offer(version=1),
                offer(last_round=1 + MIN_LAG, qc=side.qc_for_block(blocks[MIN_LAG])),
            ]
            verdicts = tuple(client._acceptable(m, 0, 1) for m in cases)
            client.network.close()
            return verdicts
        finally:
            store.close()

    return asyncio.run(judge())


def test_both_packages_reject_the_same_offers(tmp_path):
    verdicts = _offers(PORT, tmp_path)
    assert verdicts == _offers(JAX, tmp_path)
    assert verdicts == (True, False, False, False, False, False, False)


# ---- counterparts of tests/test_reconfig.py's splice tests -----------------

MARGIN = 4


def _five_keys(side):
    pairs = [side.crypto.generate_keypair(SEED, i) for i in range(5)]
    pairs.sort(key=lambda kp: kp[0])
    return pairs


def _epoch(side, ks, members, epoch: int):
    return side.consensus.Committee.new(
        [(ks[i][0], 1, ("127.0.0.1", 9_400 + i)) for i in members], epoch=epoch
    )


def _sponsored(side, new_committee, sponsor):
    reconfig = importlib.import_module(f"{side.root}.consensus.reconfig")
    op = reconfig.ReconfigOp(new_committee=new_committee, margin=MARGIN, sponsor=sponsor[0])
    op.signature = side.crypto.Signature.new(side.crypto.Digest(op.digest()), sponsor[1])
    return op


def _reconfig_block(side, op, author, round_):
    block = side.consensus.Block(qc=side.consensus.QC.genesis(), author=author[0], round=round_, reconfig=op)
    block.signature = side.crypto.Signature.new(block.digest(), author[1])
    return block


def _qc_over(side, block, ks, voters=3):
    c = side.consensus
    vote_digest = c.Vote.for_block(block, ks[0][0]).digest()
    return c.QC(
        hash=block.digest(), round=block.round,
        votes=[(pk, side.crypto.Signature.new(vote_digest, sk)) for pk, sk in ks[:voters]],
    )


def _qc_bytes(side, qc) -> bytes:
    enc = importlib.import_module(f"{side.root}.utils.codec").Encoder()
    qc.encode(enc)
    return enc.finish()


@pytest.mark.parametrize("side", [JAX, PORT], ids=["jax", "port"])
def test_splice_is_idempotent_and_monotonic(side):
    InvalidCommittee = importlib.import_module(f"{side.root}.consensus.config").InvalidCommittee
    ks = _five_keys(side)
    epoch1 = _epoch(side, ks, range(4), 1)
    epoch2 = _epoch(side, ks, (0, 1, 2, 4), 2)
    schedule = side.consensus.CommitteeSchedule([(1, epoch1)])
    gen = schedule.generation
    assert schedule.splice(10, epoch2) is True
    assert schedule.generation == gen + 1
    assert schedule.for_round(9) is epoch1
    assert schedule.for_round(10) is epoch2
    assert schedule.splice(10, epoch2) is False
    assert schedule.generation == gen + 1
    with pytest.raises(InvalidCommittee):
        schedule.splice(8, side.consensus.Committee(
            authorities=dict(epoch2.authorities), epoch=3, scheme="ed25519"
        ))
    with pytest.raises(InvalidCommittee):
        schedule.splice(20, epoch1)


def _walk(side) -> list:
    """The certified-link walk through ``side``'s ``splice_schedule_links``:
    what each step returned or raised."""
    reconfig = importlib.import_module(f"{side.root}.consensus.reconfig")
    errors = importlib.import_module(f"{side.root}.consensus.errors")
    verifier = side.service.CpuVerifier()
    ks = _five_keys(side)
    op = _sponsored(side, _epoch(side, ks, (0, 1, 2, 4), 2), ks[0])
    block = _reconfig_block(side, op, ks[1], 6)
    links = [(block.serialize(), _qc_bytes(side, _qc_over(side, block, ks)))]

    def fresh():
        return side.consensus.CommitteeSchedule([(1, _epoch(side, ks, range(4), 1))])

    out = []
    joiner = fresh()
    out.append(reconfig.splice_schedule_links(links, joiner, verifier))
    out.append((joiner.for_round(6 + MARGIN).epoch, joiner.for_round(6 + MARGIN - 1).epoch))
    out.append(reconfig.splice_schedule_links(links, joiner, verifier))
    other = _reconfig_block(side, op, ks[2], 6)
    for bad in (
        [(block.serialize(), _qc_bytes(side, _qc_over(side, other, ks)))],
        [(block.serialize(), _qc_bytes(side, _qc_over(side, block, ks, voters=2)))],
        [(b"\x00garbage", b"")],
        [(_reconfig_block(side, None, ks[1], 6).serialize(), links[0][1])],
    ):
        try:
            reconfig.splice_schedule_links(bad, fresh(), verifier)
            out.append("accepted")
        except errors.InvalidReconfig as e:
            out.append(str(e).split(": ")[1])
    try:
        reconfig.splice_schedule_links(links, _epoch(side, ks, range(4), 1), verifier)
        out.append("accepted")
    except errors.InvalidReconfig as e:
        out.append(str(e).split(": ")[1])
    out.append(reconfig.splice_schedule_links([], fresh(), verifier))
    return out


def test_splice_schedule_links_walk_matches_jax():
    """A joiner holding only the genesis committee replays a certified
    (block, QC) chain into the live schedule, skips it on replay, and
    rejects a QC of another block, a sub-quorum QC, corrupt bytes, a
    block without an op and a static committee — with the same results
    and messages in both packages."""
    port = _walk(PORT)
    assert port == _walk(JAX)
    assert port[:3] == [1, (2, 1), 0]
    assert port[3:7] == [
        "schedule link QC does not certify its block",
        "schedule link QC failed to verify",
        "corrupt schedule link",
        "schedule link carries no reconfig op",
    ]
    assert port[7] == "static committee cannot accept schedule links" and port[8] == 0
