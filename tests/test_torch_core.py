"""The port's consensus core and its components against the JAX
package's: the counterparts of tests/test_core.py and
tests/test_consensus_components.py on ``hotstuff_tpu_torch.consensus``;
one scripted message sequence through a JAX ``Core`` and a port
``Core`` giving byte-equal outbound frames, the same commits and
byte-equal persisted state; and a port ``Core`` resuming from a store a
JAX core wrote (and the other way round).

Fixtures are built for either package from one seed (``Side``), and
every port a peer listens on comes from the OS (``reserve_ports``)."""

import asyncio
import importlib
import logging
import os
from types import SimpleNamespace

import pytest

from hotstuff_tpu_torch.bench.committee import reserve_ports

SEED = bytes(32)


class Side:
    """One package's consensus-facing API and its test fixtures:
    ``Side("hotstuff_tpu")`` (the JAX reference) or
    ``Side("hotstuff_tpu_torch")`` (the port)."""

    def __init__(self, root: str):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.consensus = mod("consensus")
        self.core = mod("consensus.core")
        self.proposer = mod("consensus.proposer")
        self.helper = mod("consensus.helper")
        self.leader = mod("consensus.leader")
        self.wire = mod("consensus.wire")
        self.errors = mod("consensus.errors")
        self.crypto = mod("crypto")
        self.service = mod("crypto.service")
        self.async_service = mod("crypto.async_service")
        self.store = mod("store")
        self.network = mod("network")
        self.utils_codec = mod("utils.codec")

    def keys(self, n: int = 4):
        """Deterministic committee keypairs, ordered by public key (index i
        leads round r when r % n == i)."""
        pairs = [self.crypto.generate_keypair(SEED, i) for i in range(n)]
        pairs.sort(key=lambda kp: kp[0])
        return pairs

    def committee(self, ports, n: int = 4):
        return self.consensus.Committee.new(
            [(pk, 1, ("127.0.0.1", port)) for (pk, _), port in zip(self.keys(n), ports)]
        )

    def signed_block(self, author, secret, round_, qc=None, tc=None, payload=None):
        c = self.consensus
        block = c.Block(
            qc=qc if qc is not None else c.QC.genesis(),
            tc=tc,
            author=author,
            round=round_,
            payloads=(payload,) if payload is not None else (),
        )
        block.signature = self.crypto.Signature.new(block.digest(), secret)
        return block

    def signed_vote(self, block, author, secret):
        vote = self.consensus.Vote.for_block(block, author)
        vote.signature = self.crypto.Signature.new(vote.digest(), secret)
        return vote

    def signed_timeout(self, high_qc, round_, author, secret):
        timeout = self.consensus.Timeout(high_qc=high_qc, round=round_, author=author)
        timeout.signature = self.crypto.Signature.new(timeout.digest(), secret)
        return timeout

    def qc_for_block(self, block, n: int = 4, voters: int = 3):
        vote_digest = self.consensus.Vote.for_block(block, self.keys(n)[0][0]).digest()
        return self.consensus.QC(
            hash=block.digest(),
            round=block.round,
            votes=[
                (pk, self.crypto.Signature.new(vote_digest, sk))
                for pk, sk in self.keys(n)[:voters]
            ],
        )

    def payload(self, i: int):
        return self.crypto.Digest.of(b"payload %d" % i)

    def chain(self, length: int, n: int = 4):
        """A valid chain b1..b_length with full QCs, each block authored by
        its round's leader and carrying one seeded payload."""
        pairs = self.keys(n)
        blocks = []
        qc = self.consensus.QC.genesis()
        for round_ in range(1, length + 1):
            author, secret = pairs[round_ % n]
            block = self.signed_block(author, secret, round_, qc=qc, payload=self.payload(round_))
            blocks.append(block)
            qc = self.qc_for_block(block, n)
        return blocks


JAX = Side("hotstuff_tpu")
PORT = Side("hotstuff_tpu_torch")
S = PORT


async def listener(sock, expected: bytes | None = None, reply: bytes = b"Ack") -> bytes:
    """A peer on the reserved socket ``sock``: accept one connection,
    return its first frame (optionally asserting it), reply with an
    ACK."""
    received = asyncio.get_running_loop().create_future()

    async def handle(reader, writer):
        try:
            frame = await S.network.read_frame(reader)
            await S.network.send_frame(writer, reply)
            if not received.done():
                received.set_result(frame)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handle, sock=sock)
    try:
        frame = await received
    finally:
        server.close()
    if expected is not None:
        assert frame == expected, "listener received unexpected frame"
    return frame


def make_core(tmp_path, name_idx, timeout_ms=10_000, side=S, state=False):
    """A core (not spawned) on a real store, signing service and
    synchronizer, with an execution layer when ``state``; ``socks``
    holds the committee's reserved ports."""
    socks = reserve_ports(4)
    store = side.store.Store(str(tmp_path / f"db-{side.root}"))
    com = side.committee([s.getsockname()[1] for s in socks])
    name, secret = side.keys()[name_idx]
    rx_events, rx_message, loopback = side.core.make_event_channels(2_000)
    tx_proposer: asyncio.Queue = asyncio.Queue()
    tx_commit: asyncio.Queue = asyncio.Queue()
    sync = side.consensus.Synchronizer(name, com, store, loopback, 10_000)
    core = side.consensus.Core(
        name,
        com,
        side.crypto.SignatureService(secret),
        side.service.CpuVerifier(),
        store,
        side.leader.LeaderElector(com),
        sync,
        timeout_ms,
        rx_events=rx_events,
        rx_loopback=loopback,
        tx_proposer=tx_proposer,
        tx_commit=tx_commit,
        state_machine=(
            importlib.import_module(f"{side.root}.store.state").StateMachine(store)
            if state else None
        ),
    )
    return SimpleNamespace(
        core=core, store=store, committee=com, name=name, secret=secret,
        rx_message=rx_message, tx_proposer=tx_proposer, tx_commit=tx_commit,
        sync=sync, socks=socks,
    )


def teardown(h):
    h.core.shutdown()
    h.sync.shutdown()
    h.store.close()
    for s in h.socks:
        s.close()


def async_test(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))

    return wrapper


# ---- counterparts of tests/test_core.py ------------------------------------


@async_test
async def test_handle_proposal_votes_to_next_leader(tmp_path):
    h = make_core(tmp_path, name_idx=0)  # not leader of rounds 1/2
    b1 = S.chain(1)[0]
    expected_vote = S.signed_vote(b1, h.name, h.secret)
    listen = asyncio.ensure_future(listener(h.socks[2], S.wire.encode_vote(expected_vote)))
    await asyncio.sleep(0.05)
    h.core.spawn()
    await h.rx_message.put((S.wire.TAG_PROPOSE, b1))
    await asyncio.wait_for(listen, timeout=2.0)
    teardown(h)


async def _next_make(h):
    # round advances also emit best-effort Cleanup pings; the MAKE is
    # the first non-cleanup message
    while True:
        message = await asyncio.wait_for(h.tx_proposer.get(), timeout=2.0)
        if message.kind == S.consensus.ProposerMessage.MAKE:
            return message


@async_test
async def test_generate_proposal_after_quorum(tmp_path):
    h = make_core(tmp_path, name_idx=2)  # leader of round 2
    b1 = S.chain(1)[0]
    h.core.spawn()
    for pk, sk in S.keys()[:3]:
        await h.rx_message.put((S.wire.TAG_VOTE, S.signed_vote(b1, pk, sk)))
    message = await _next_make(h)
    assert message.round == 2
    assert message.qc.hash == b1.digest()
    assert message.qc.round == 1
    assert message.tc is None
    teardown(h)


@async_test
async def test_commit_chain_head(tmp_path):
    h = make_core(tmp_path, name_idx=0)
    blocks = S.chain(3)
    h.core.spawn()
    for b in blocks:
        await h.rx_message.put((S.wire.TAG_PROPOSE, b))
    committed = await asyncio.wait_for(h.tx_commit.get(), timeout=2.0)
    assert committed.digest() == blocks[0].digest()
    teardown(h)


@async_test
async def test_local_timeout_broadcasts(tmp_path):
    h = make_core(tmp_path, name_idx=0, timeout_ms=100)
    expected = S.wire.encode_timeout(
        S.signed_timeout(S.consensus.QC.genesis(), 1, h.name, h.secret)
    )
    listens = [asyncio.ensure_future(listener(h.socks[i], expected)) for i in (1, 2, 3)]
    await asyncio.sleep(0.05)
    h.core.spawn()
    await asyncio.wait_for(asyncio.gather(*listens), timeout=2.0)
    assert h.core.local_timeouts >= 1
    teardown(h)


@async_test
async def test_timeout_join_round_sync(tmp_path):
    """f+1 distinct timeouts for a round AHEAD of ours make the core join
    that round and emit its own timeout (round synchronization)."""
    h = make_core(tmp_path, name_idx=0, timeout_ms=60_000)
    try:
        ks = S.keys()
        genesis = S.consensus.QC.genesis()
        assert h.core.round == 1
        await h.core._handle_timeout(S.signed_timeout(genesis, 3, ks[1][0], ks[1][1]))
        assert h.core.round == 1
        await h.core._handle_timeout(S.signed_timeout(genesis, 3, ks[2][0], ks[2][1]))
        assert h.core.round == 4
    finally:
        teardown(h)


async def _feed_junk(h, junk):
    while True:
        try:
            h.rx_message.put_nowait((S.wire.TAG_VOTE, junk))
        except asyncio.QueueFull:
            pass
        await asyncio.sleep(0.01)


@async_test
async def test_local_timeout_fires_under_message_flood(tmp_path):
    """A flood of cheap messages queued ahead of the timer delays the
    local timeout by at most one processing batch."""
    h = make_core(tmp_path, name_idx=0, timeout_ms=150)
    expected = S.wire.encode_timeout(
        S.signed_timeout(S.consensus.QC.genesis(), 1, h.name, h.secret)
    )
    listens = [asyncio.ensure_future(listener(h.socks[i], expected)) for i in (1, 2, 3)]
    await asyncio.sleep(0.05)
    pk, sk = S.keys()[1]
    junk = S.signed_vote(S.chain(1)[0], pk, sk)
    junk.round = 10_000
    for _ in range(1_500):
        h.rx_message.put_nowait((S.wire.TAG_VOTE, junk))
    h.core.spawn()
    feed = asyncio.ensure_future(_feed_junk(h, junk))
    try:
        await asyncio.wait_for(asyncio.gather(*listens), timeout=2.0)
    finally:
        feed.cancel()
    teardown(h)


@async_test
async def test_loopback_backlog_drains_without_external_wakeups(tmp_path):
    """>64 loopback blocks queued in one burst exceed the per-iteration
    drain cap; the re-armed wake token keeps the loop draining them."""
    h = make_core(tmp_path, name_idx=0, timeout_ms=60_000)
    b1 = S.chain(1)[0]
    h.core.spawn()
    for _ in range(150):
        h.core.rx_loopback.put_nowait(b1)
    deadline = asyncio.get_running_loop().time() + 2.0
    while h.core.rx_loopback.qsize() > 0:
        assert asyncio.get_running_loop().time() < deadline, (
            f"loopback backlog stranded: {h.core.rx_loopback.qsize()} left"
        )
        await asyncio.sleep(0.02)
    teardown(h)


@async_test
async def test_loopback_processed_under_message_flood(tmp_path):
    """Own/sync-resumed blocks ride a priority channel drained every
    iteration: a loopback proposal still produces our vote while junk
    floods the message queue."""
    h = make_core(tmp_path, name_idx=0, timeout_ms=60_000)
    b1 = S.chain(1)[0]
    expected_vote = S.signed_vote(b1, h.name, h.secret)
    listen = asyncio.ensure_future(listener(h.socks[2], S.wire.encode_vote(expected_vote)))
    await asyncio.sleep(0.05)
    pk, sk = S.keys()[1]
    junk = S.signed_vote(b1, pk, sk)
    junk.round = 10_000
    for _ in range(1_500):
        h.rx_message.put_nowait((S.wire.TAG_VOTE, junk))
    h.core.spawn()
    feed = asyncio.ensure_future(_feed_junk(h, junk))
    try:
        await h.core.rx_loopback.put(b1)
        await asyncio.wait_for(listen, timeout=2.0)
    finally:
        feed.cancel()
    teardown(h)


@async_test
async def test_state_persisted_after_vote(tmp_path):
    h = make_core(tmp_path, name_idx=0)
    b1 = S.chain(1)[0]
    listen = asyncio.ensure_future(listener(h.socks[2]))  # the vote's target
    h.core.spawn()
    await h.rx_message.put((S.wire.TAG_PROPOSE, b1))
    await asyncio.wait_for(listen, timeout=2.0)  # the vote left after the persist
    raw = await h.store.read(S.core.CONSENSUS_STATE_KEY)
    assert raw is not None
    state = S.consensus.ConsensusState.deserialize(raw)
    assert state.last_voted_round == 1
    teardown(h)


@async_test
async def test_recovery_resumes_round(tmp_path):
    """A restarted core reloads its persisted round and, as leader of that
    round, immediately proposes."""
    h = make_core(tmp_path, name_idx=3)  # leader of round 7
    state = S.consensus.ConsensusState(round_=7, last_voted_round=6, last_committed_round=5)
    await h.store.write(S.core.CONSENSUS_STATE_KEY, state.serialize())
    h.core.spawn()
    message = await asyncio.wait_for(h.tx_proposer.get(), timeout=2.0)
    assert message.kind == S.consensus.ProposerMessage.MAKE
    assert message.round == 7
    assert h.core.last_voted_round == 6
    assert h.core.last_committed_round == 5
    teardown(h)


@async_test
async def test_allow_empty_proposal_when_payloads_in_flight(tmp_path):
    h = make_core(tmp_path, name_idx=3)  # leader of round 3
    blocks = S.chain(2)
    h.core.spawn()
    for b in blocks:
        await h.rx_message.put((S.wire.TAG_PROPOSE, b))
    for pk, sk in S.keys()[:3]:
        await h.rx_message.put((S.wire.TAG_VOTE, S.signed_vote(blocks[1], pk, sk)))
    message = await _next_make(h)
    assert message.round == 3
    assert message.allow_empty
    teardown(h)


@async_test
async def test_proposer_makes_empty_block_when_allowed(tmp_path):
    """Proposer with an empty buffer: allow_empty Make emits an empty
    block on the loopback; without allow_empty it defers."""
    socks = reserve_ports(4)
    name, secret = S.keys()[0]
    com = S.committee([s.getsockname()[1] for s in socks])
    loopback: asyncio.Queue = asyncio.Queue()
    proposer = S.consensus.Proposer(
        name,
        com,
        S.crypto.SignatureService(secret),
        rx_producer=asyncio.Queue(),
        rx_message=asyncio.Queue(),
        tx_loopback=loopback,
    )
    genesis = S.consensus.QC.genesis()
    await proposer._make_block(5, genesis, None, allow_empty=False)
    assert proposer.deferred is not None and loopback.empty()
    task = asyncio.ensure_future(proposer._make_block(5, genesis, None, allow_empty=True))
    block = await asyncio.wait_for(loopback.get(), timeout=2.0)
    assert block.round == 5 and block.payloads == ()
    task.cancel()
    proposer.shutdown()
    for s in socks:
        s.close()


@async_test
async def test_wrong_leader_proposal_rejected(tmp_path):
    """A proposal authored by anyone but the round's leader produces no
    vote (WrongLeader)."""
    h = make_core(tmp_path, name_idx=0)
    author, secret = S.keys()[3]  # round 1's leader is keys()[1]
    bad = S.signed_block(author, secret, 1, payload=S.payload(1))
    listen = asyncio.ensure_future(listener(h.socks[2]))  # round-2 leader's port
    await asyncio.sleep(0.05)
    h.core.spawn()
    await h.rx_message.put((S.wire.TAG_PROPOSE, bad))
    with pytest.raises(asyncio.TimeoutError):
        await asyncio.wait_for(asyncio.shield(listen), timeout=0.6)
    listen.cancel()
    with pytest.raises(S.errors.WrongLeader):
        await h.core._handle_proposal(bad)
    teardown(h)


async def _fire_timer(core):
    # as in Core.run: re-firing for the same round raises a benign
    # AuthorityReuse from the aggregator, which the loop logs
    try:
        await core._local_timeout_round()
    except S.errors.ConsensusError:
        pass


@async_test
async def test_timeout_backoff_grows_and_resets_on_progress(tmp_path):
    h = make_core(tmp_path, 0, timeout_ms=100)
    try:
        core = h.core
        base = 0.1
        assert core.timer.duration == base
        core.last_payload_round = 1  # active committee
        for expected_exp in (1, 2, 3):
            await _fire_timer(core)
            assert core._timeout_exponent == expected_exp
            assert core.timer.duration == base * 2**expected_exp
        core._timeout_cap_ms = 500
        await _fire_timer(core)
        assert core.timer.duration == 0.5
        core._advance_round(core.round, via_tc=True)
        assert core._timeout_exponent == 0
        assert core.timer.duration == base
        await _fire_timer(core)
        assert core._timeout_exponent == 1
        core._advance_round(core.round, via_tc=True)
        assert core._timeout_exponent == 1
        assert core.timer.duration == base * 2
        qc = S.chain(4)[-1].qc
        core.round = qc.round
        core._process_qc(qc)
        assert core._timeout_exponent == 0
        assert core._consecutive_tcs == 0
        assert core.timer.duration == base
    finally:
        teardown(h)


@async_test
async def test_idle_timeouts_keep_base_timer(tmp_path):
    h = make_core(tmp_path, 0, timeout_ms=100)
    try:
        core = h.core
        for _ in range(4):
            await _fire_timer(core)
            core._advance_round(core.round, via_tc=True)
        assert core._timeout_exponent == 0
        assert core.timer.duration == 0.1
        core._saw_proposal = True
        await _fire_timer(core)
        assert core._timeout_exponent == 1
        assert core.timer.duration == 0.2
    finally:
        teardown(h)


@async_test
async def test_timeout_burst_aggregate_verification(tmp_path):
    """A timeout flood in one burst verifies as ONE coalesced claim batch;
    a garbage timeout sends its group to per-item verification; a
    non-member never joins an aggregate."""
    calls = {"one": 0, "many": 0}

    class CountingVerifier(S.service.CpuVerifier):
        def verify_one(self, d, pk, sig):
            calls["one"] += 1
            return super().verify_one(d, pk, sig)

        def verify_many(self, digests, pks, sigs, aggregate_ok=False):
            calls["many"] += 1
            return super().verify_many(digests, pks, sigs)

    h = make_core(tmp_path, 0, timeout_ms=60_000)
    try:
        genesis = S.consensus.QC.genesis()
        TAG_TIMEOUT = S.wire.TAG_TIMEOUT
        h.core.verifier = CountingVerifier()
        h.core.averifier = S.async_service.AsyncVerifyService.for_backend(h.core.verifier)
        ks = S.keys()
        burst = [(TAG_TIMEOUT, S.signed_timeout(genesis, 1, pk, sk)) for pk, sk in ks[:3]]
        assert await h.core._preverify_burst(burst) == {0, 1, 2}
        # one aggregated crypto call, zero per-item checks: with the
        # native library the whole wave is ONE flat batch equation
        # (verify_many never runs); with it off, one verify_many call
        from hotstuff_tpu_torch.crypto import native_ed25519

        assert calls == {"one": 0, "many": 0 if native_ed25519.available() else 1}

        bad = S.signed_timeout(genesis, 1, ks[2][0], ks[2][1])
        bad.signature = S.crypto.Signature(b"\x01" * 64)
        burst_bad = [
            (TAG_TIMEOUT, S.signed_timeout(genesis, 1, ks[0][0], ks[0][1])),
            (TAG_TIMEOUT, S.signed_timeout(genesis, 1, ks[1][0], ks[1][1])),
            (TAG_TIMEOUT, bad),
        ]
        assert await h.core._preverify_burst(burst_bad) == set()

        spk, ssk = S.crypto.generate_keypair(b"\x77" * 32, 0)  # not in committee
        burst_mixed = [
            (TAG_TIMEOUT, S.signed_timeout(genesis, 1, ks[0][0], ks[0][1])),
            (TAG_TIMEOUT, S.signed_timeout(genesis, 1, spk, ssk)),
            (TAG_TIMEOUT, S.signed_timeout(genesis, 1, ks[1][0], ks[1][1])),
        ]
        assert await h.core._preverify_burst(burst_mixed) == {0, 2}
        await h.core._handle_timeout(burst_bad[0][1])
        with pytest.raises(S.errors.InvalidSignature):
            await h.core._handle_timeout(bad)
    finally:
        teardown(h)


@async_test
async def test_timeout_burst_mixed_rounds_group_separately(tmp_path):
    """Timeouts for different rounds (distinct digests) in one burst form
    one shared claim per round, each verified on its own.  (The JAX
    test counts shared-message checks on an aggregate-preferring BLS
    backend; that route is not ported, so the claims are inspected.)"""
    h = make_core(tmp_path, 0, timeout_ms=60_000)
    try:
        genesis = S.consensus.QC.genesis()
        TAG_TIMEOUT = S.wire.TAG_TIMEOUT
        submitted = []
        service = h.core.averifier
        verify_claims = service.verify_claims

        async def recording(claims):
            submitted.append(list(claims))
            return await verify_claims(claims)

        service.verify_claims = recording
        ks = S.keys()
        timeouts = [S.signed_timeout(genesis, 1 + i % 2, ks[i][0], ks[i][1]) for i in range(4)]
        burst = [(TAG_TIMEOUT, t) for t in timeouts]
        assert await h.core._preverify_burst(burst) == {0, 1, 2, 3}
        (claims,) = submitted
        assert [c[0] for c in claims] == ["shared", "shared"]
        for claim, members in zip(claims, (timeouts[0::2], timeouts[1::2])):
            assert claim[1] == members[0].digest().to_bytes()
            assert claim[2] == tuple((t.author.to_bytes(), t.signature.to_bytes()) for t in members)
    finally:
        teardown(h)


@async_test
async def test_preverify_skips_far_future_votes(tmp_path):
    """Votes and timeouts beyond the aggregator's ROUND_LOOKAHEAD are
    rejected with ZERO crypto — the preverify batch must not turn that
    free rejection into signature work."""
    calls = []

    class Counting(S.service.CpuVerifier):
        def verify_many(self, d, p, s, aggregate_ok=False):
            calls.append(len(d))
            return super().verify_many(d, p, s)

        def verify_one(self, d, pk, sig):
            calls.append(1)
            return super().verify_one(d, pk, sig)

        def verify_shared_msg(self, d, votes):
            calls.append(len(votes))
            return super().verify_shared_msg(d, votes)

    from hotstuff_tpu_torch.consensus.aggregator import ROUND_LOOKAHEAD

    h = make_core(tmp_path, 0, timeout_ms=60_000)
    try:
        h.core.verifier = Counting()
        pk, sk = S.keys()[1]
        far = S.consensus.Vote(
            hash=S.crypto.Digest.of(b"far"), round=h.core.round + ROUND_LOOKAHEAD + 1, author=pk
        )
        far.signature = S.crypto.Signature.new(far.digest(), sk)
        assert await h.core._preverify_burst([(S.wire.TAG_VOTE, far)]) == set()
        t = S.signed_timeout(h.core.high_qc, h.core.round + ROUND_LOOKAHEAD + 1, pk, sk)
        assert await h.core._preverify_burst([(S.wire.TAG_TIMEOUT, t)]) == set()
        assert calls == []
    finally:
        teardown(h)


# ---- counterparts of tests/test_consensus_components.py --------------------


@async_test
async def test_timer_fires_after_delay():
    timer = S.consensus.Timer(50)
    timer.reset()
    await asyncio.wait_for(timer.wait(), timeout=1.0)


@async_test
async def test_timer_reset_postpones():
    timer = S.consensus.Timer(100)
    timer.reset()
    waiter = asyncio.ensure_future(timer.wait())
    await asyncio.sleep(0.06)
    timer.reset()  # push the deadline out
    await asyncio.sleep(0.06)
    assert not waiter.done()
    await asyncio.wait_for(waiter, timeout=1.0)


def _sync(tmp_path, loopback=None):
    socks = reserve_ports(4)
    store = S.store.Store(str(tmp_path / "db"))
    sync = S.consensus.Synchronizer(
        S.keys()[0][0],
        S.committee([s.getsockname()[1] for s in socks]),
        store,
        loopback if loopback is not None else asyncio.Queue(),
        10_000,
    )
    return sync, store, socks


@async_test
async def test_synchronizer_parent_hit(tmp_path):
    sync, store, socks = _sync(tmp_path)
    blocks = S.chain(2)
    await store.write(blocks[0].digest().to_bytes(), blocks[0].serialize())
    parent = await sync.get_parent_block(blocks[1])
    assert parent is not None and parent.digest() == blocks[0].digest()
    sync.shutdown()
    store.close()
    for s in socks:
        s.close()


@async_test
async def test_synchronizer_genesis(tmp_path):
    sync, store, socks = _sync(tmp_path)
    assert await sync.get_parent_block(S.chain(1)[0]) == S.consensus.Block.genesis()
    sync.shutdown()
    store.close()
    for s in socks:
        s.close()


@async_test
async def test_synchronizer_miss_requests_then_loopback(tmp_path):
    """Store miss: a SyncRequest goes to the block author; once the parent
    is written, the suspended child comes back on the loopback."""
    loopback: asyncio.Queue = asyncio.Queue()
    sync, store, socks = _sync(tmp_path, loopback)
    blocks = S.chain(2)
    name = S.keys()[0][0]
    author = [pk for pk, _ in S.keys()].index(blocks[1].author)
    expected = S.wire.encode_sync_request(blocks[0].digest(), name)
    listen = asyncio.ensure_future(listener(socks[author], expected))
    await asyncio.sleep(0.05)
    assert await sync.get_parent_block(blocks[1]) is None
    await asyncio.wait_for(listen, timeout=2.0)
    await store.write(blocks[0].digest().to_bytes(), blocks[0].serialize())
    child = await asyncio.wait_for(loopback.get(), timeout=2.0)
    assert child.digest() == blocks[1].digest()
    sync.shutdown()
    store.close()
    for s in socks:
        s.close()


@async_test
async def test_synchronizer_snapshot_barrier(tmp_path):
    """A missing parent certified at or below the floor resolves to the
    genesis stand-in instead of a network fetch."""
    sync, store, socks = _sync(tmp_path)
    child = S.chain(2)[1]  # its parent is deliberately NOT in the store
    genesis = S.consensus.Block.genesis()
    assert await sync.get_parent_block(child, floor=child.qc.round) == genesis
    assert not sync._requests and not sync._pending
    assert await sync.get_parent_block(child, floor=child.qc.round - 1) is None
    assert sync._requests and sync._pending
    sync2 = S.consensus.Synchronizer(sync.name, sync.committee, store, asyncio.Queue(), 10_000)
    assert await sync2.get_ancestors(child, floor=child.qc.round) == (genesis, genesis)
    assert not sync2._requests
    sync.shutdown()
    sync2.shutdown()
    store.close()
    for s in socks:
        s.close()


def test_parameters_reject_incoherent_backoff():
    from hotstuff_tpu_torch.consensus.config import InvalidParameters, Parameters

    with pytest.raises(InvalidParameters):
        Parameters(timeout_backoff=0.5)
    with pytest.raises(InvalidParameters):
        Parameters(timeout_delay=5_000, timeout_cap_ms=1_000)
    with pytest.raises(InvalidParameters):
        Parameters.from_json({"timeout_backoff": 0.9})
    Parameters(timeout_backoff=1.0)


def test_leader_cache_distinguishes_same_epoch_committees():
    """The elector's key cache never aliases two distinct committee
    objects, even schedule entries sharing the default epoch number —
    and it elects the JAX package's leaders."""
    from hotstuff_tpu_torch.consensus.config import CommitteeSchedule

    c1 = S.committee(range(7000, 7004))
    c2 = S.committee(range(7100, 7104))
    drop = c2.sorted_keys()[0]
    del c2.authorities[drop]
    schedule = CommitteeSchedule([(1, c1), (100, c2)])
    elector = S.leader.RoundRobinLeaderElector(schedule)
    assert elector.get_leader(4) == c1.sorted_keys()[4 % 4]
    assert elector.get_leader(103) == c2.sorted_keys()[103 % 3]
    assert elector.get_leader(103) != drop
    jelector = JAX.leader.RoundRobinLeaderElector(JAX.committee(range(7000, 7004)))
    for r in range(12):
        assert elector.get_leader(r).to_bytes() == jelector.get_leader(r).to_bytes()


def test_proposer_inflight_bound_requeues_oldest():
    """inflight does not grow without bound when commit signals stall —
    the oldest undecided proposal's payloads return to the buffer."""
    import logging
    from collections import OrderedDict

    P = S.proposer
    proposer = P.Proposer.__new__(P.Proposer)  # state-only exercise
    proposer.pending = OrderedDict()
    proposer.committed_seen = OrderedDict()
    proposer.inflight = {}
    proposer.log = logging.getLogger("test-proposer")
    digests = [S.crypto.Digest(bytes([i]) * 32) for i in range(8)]
    for r in range(1, 6):
        proposer.inflight[r] = (digests[r],)
    proposer.committed_seen[digests[1]] = None  # round 1's payload committed
    old_cap = P.MAX_INFLIGHT
    P.MAX_INFLIGHT = 3
    try:
        while len(proposer.inflight) > P.MAX_INFLIGHT:
            proposer._requeue_oldest_inflight()
    finally:
        P.MAX_INFLIGHT = old_cap
    assert set(proposer.inflight) == {3, 4, 5}
    assert list(proposer.pending) == [digests[2]]


@async_test
async def test_helper_replies_to_sync_request(tmp_path):
    """Helper reads the requested block and sends it back as a Propose."""
    socks = reserve_ports(4)
    store = S.store.Store(str(tmp_path / "db"))
    com = S.committee([s.getsockname()[1] for s in socks])
    block = S.chain(1)[0]
    await store.write(block.digest().to_bytes(), block.serialize())
    requests: asyncio.Queue = asyncio.Queue()
    helper = S.helper.Helper(com, store, requests)
    helper.spawn()
    listen = asyncio.ensure_future(listener(socks[1]))
    await asyncio.sleep(0.05)
    await requests.put((block.digest(), S.keys()[1][0]))
    frame = await asyncio.wait_for(listen, timeout=2.0)
    assert frame == S.wire.encode_propose(block)
    tag, payload = S.wire.decode_message(frame)
    assert tag == S.wire.TAG_PROPOSE and payload.digest() == block.digest()
    helper.shutdown()
    store.close()
    for s in socks:
        s.close()


# ---- the JAX core and the port core on one scripted sequence --------------


class _Peer:
    """A peer on a reserved socket that records every frame on every
    connection and ACKs each one."""

    def __init__(self, sock):
        self.sock = sock
        self.frames: list[bytes] = []
        self.server = None

    async def start(self):
        async def handle(reader, writer):
            try:
                while True:
                    frame = await S.network.read_frame(reader)
                    self.frames.append(frame)
                    await S.network.send_frame(writer, b"Ack")
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            finally:
                writer.close()

        self.server = await asyncio.start_server(handle, sock=self.sock)


class _Lines(logging.Handler):
    """The log lines of the named loggers, by logger name, as a node log
    holds them: a fixed timestamp, then the message (the form
    benchmark/logs.py parses)."""

    def __init__(self, *logger_names: str):
        super().__init__(logging.INFO)
        self.lines: dict[str, list[str]] = {name: [] for name in logger_names}
        self._loggers = [logging.getLogger(name) for name in logger_names]
        self._levels = [logger.level for logger in self._loggers]
        for logger in self._loggers:
            logger.setLevel(logging.INFO)
            logger.addHandler(self)

    def emit(self, record) -> None:
        self.lines[record.name].append("2026-01-01T00:00:00.000Z " + record.getMessage())

    def close(self) -> None:
        for logger, level in zip(self._loggers, self._levels):
            logger.removeHandler(self)
            logger.setLevel(level)
        super().close()


async def _script(side: Side, tmp_path, state: bool = False) -> dict:
    """Drive node 0's core and proposer through one scripted sequence by
    calling the handlers the run loop calls, in order, persisting after
    each step as the run loop does:

    b1, b2, b3 arrive (votes to the round 2, 3 and 4 leaders; b3 commits
    b1; node 0 leads round 4, so its own vote stays home); votes for b3
    from nodes 1 and 2 form the QC; the MAKE for round 4 becomes block
    b4 with a buffered payload, broadcast to the peers; b4 loops back
    (commits b2, votes to node 1); the round-4 timer fires (a Timeout to
    every peer); timeouts of nodes 1 and 2 form the TC, broadcast to
    every peer; the core moves to round 5 and its timer fires again.
    With ``state``, the core applies each commit to a ``StateMachine``
    and the core logger's lines are returned."""
    h = make_core(tmp_path, 0, timeout_ms=60_000, side=side, state=state)
    core_log = f"{side.root}.consensus.core.{str(h.name)[:8]}"
    lines = _Lines(core_log)
    peers = [_Peer(s) for s in h.socks[1:]]
    for p in peers:
        await p.start()
    proposer = side.consensus.Proposer(
        h.name,
        h.committee,
        h.core.signature_service,
        rx_producer=asyncio.Queue(),
        rx_message=asyncio.Queue(),
        tx_loopback=h.core.rx_loopback,
    )
    core = h.core

    async def step(coro):
        await coro
        if core.state_changed:
            await core.persist_state()
            core.state_changed = False

    try:
        ks = side.keys()
        b1, b2, b3 = side.chain(3)
        for b in (b1, b2, b3):
            await step(core._handle_proposal(b))
        for pk, sk in ks[1:3]:
            await step(core._handle_vote(side.signed_vote(b3, pk, sk)))
        make = None
        while not h.tx_proposer.empty():
            message = h.tx_proposer.get_nowait()
            if message.kind == side.consensus.ProposerMessage.MAKE:
                make = message
        assert make is not None and make.round == 4
        proposer._buffer_payload(side.payload(99))
        await asyncio.wait_for(
            proposer._make_block(make.round, make.qc, make.tc, make.allow_empty), 5
        )
        b4 = core.rx_loopback.get_nowait()
        await step(core._process_block(b4))
        await step(core._local_timeout_round())
        high_qc = core.high_qc
        for pk, sk in ks[1:3]:
            await step(core._handle_timeout(side.signed_timeout(high_qc, 4, pk, sk)))
        assert core.round == 5
        await step(core._local_timeout_round())
        # every peer gets its vote(s), the proposal, both timeouts, the TC
        want = [5, 5, 5]
        for _ in range(250):
            if [len(p.frames) for p in peers] == want:
                break
            await asyncio.sleep(0.02)
        assert [len(p.frames) for p in peers] == want
        committed = []
        while not h.tx_commit.empty():
            committed.append(h.tx_commit.get_nowait().digest().to_bytes())
        state = await h.store.read(side.core.CONSENSUS_STATE_KEY)
        out = {
            "frames": [sorted(p.frames) for p in peers],
            "committed": committed,
            "state": state,
            "round": core.round,
            "last_voted_round": core.last_voted_round,
            "high_qc": core.high_qc,
            "store_path": str(tmp_path / f"db-{side.root}"),
            "lines": lines.lines[core_log],
        }
    finally:
        lines.close()
        proposer.shutdown()
        for p in peers:
            p.server.close()
        teardown(h)
    with open(os.path.join(out["store_path"], "wal.log"), "rb") as f:
        out["wal"] = f.read()
    return out


def test_scripted_sequence_same_frames_commits_and_state(tmp_path):
    """Votes, the proposal, the timeout and the TC leave both cores as
    the same bytes; both commit b1 and b2; the persisted consensus state
    and the whole store log are byte-equal."""
    jax = asyncio.run(_script(JAX, tmp_path))
    port = asyncio.run(_script(PORT, tmp_path))
    assert port["frames"] == jax["frames"]
    tags = sorted(f[0] for f in port["frames"][0])
    assert tags == [0, 1, 2, 2, 3]  # propose, vote, two timeouts, TC
    assert port["committed"] == jax["committed"] and len(port["committed"]) == 2
    assert port["state"] == jax["state"] and port["state"] is not None
    assert port["wal"] == jax["wal"]
    assert (port["round"], port["last_voted_round"]) == (jax["round"], jax["last_voted_round"])


def test_scripted_sequence_with_state_machine_same_roots_and_store(tmp_path):
    """The scripted sequence with an execution layer on both cores: the
    same frames and commits, the same ``State root`` lines (as
    benchmark/logs.py parses them, one per commit, chained from the
    genesis root), and byte-equal store logs, the ``s/`` ledger and the
    meta cursor included."""
    from benchmark.logs import RE_STATE_ROOT

    jax = asyncio.run(_script(JAX, tmp_path / "jax", state=True))
    port = asyncio.run(_script(PORT, tmp_path / "port", state=True))
    assert port["frames"] == jax["frames"]
    assert port["committed"] == jax["committed"] and len(port["committed"]) == 2
    roots = [RE_STATE_ROOT.findall(line) for line in port["lines"]]
    roots = [m[0][1:] for m in roots if m]
    assert roots == [
        m[0][1:] for m in (RE_STATE_ROOT.findall(line) for line in jax["lines"]) if m
    ]
    assert [(v, rnd) for v, _, rnd in roots] == [("1", "1"), ("2", "2")]
    assert port["wal"] == jax["wal"]
    for key in (b"s/meta", b"s/l"):
        assert key in port["wal"]
    plain = asyncio.run(_script(PORT, tmp_path / "plain"))
    assert b"s/meta" not in plain["wal"]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_core_resumes_from_the_other_packages_store(tmp_path, writer, reader):
    """Node 0's core opened on the store the other package's node 0 core
    wrote resumes at the same round, high QC, last voted and last
    committed round — and its first timeout after the restart is the
    frame the writer's core would have sent."""
    done = asyncio.run(_script(writer, tmp_path))

    async def body():
        socks = reserve_ports(4)
        store = reader.store.Store(done["store_path"])
        com = reader.committee([s.getsockname()[1] for s in socks])
        name, secret = reader.keys()[0]
        rx_events, _, loopback = reader.core.make_event_channels(100)
        sync = reader.consensus.Synchronizer(name, com, store, loopback, 10_000)
        core = reader.consensus.Core(
            name, com, reader.crypto.SignatureService(secret),
            reader.service.CpuVerifier(), store, reader.leader.LeaderElector(com),
            sync, 200, rx_events=rx_events, rx_loopback=loopback,
            tx_proposer=asyncio.Queue(), tx_commit=asyncio.Queue(),
        )
        listen = asyncio.ensure_future(listener(socks[1]))
        try:
            await core.load_state()
            assert core.round == done["round"] == 5
            assert core.last_voted_round == done["last_voted_round"] == 5
            assert core.last_committed_round == 2
            enc = reader.utils_codec.Encoder()
            core.high_qc.encode(enc)
            jenc = writer.utils_codec.Encoder()
            done["high_qc"].encode(jenc)
            assert enc.finish() == jenc.finish()
            assert core.high_qc.round == 3
            core.spawn()
            frame = await asyncio.wait_for(listen, 2.0)
            w_name, w_secret = writer.keys()[0]
            expected = writer.wire.encode_timeout(
                writer.signed_timeout(done["high_qc"], 5, w_name, w_secret)
            )
            assert frame == expected
        finally:
            listen.cancel()
            core.shutdown()
            sync.shutdown()
            store.close()
            for s in socks:
                s.close()

    asyncio.run(body())


# ---- the receiver handler, admission and the added wire frames ------------


class _Writer:
    """A reply channel that records what the handler sends back."""

    def __init__(self):
        self.sent: list[bytes] = []

    async def send(self, payload: bytes) -> None:
        self.sent.append(payload)


def _frames(side: Side) -> list[bytes]:
    """Every kind of frame a consensus port receives, built from one seed
    in ``side``'s classes, plus malformed and unported-tag frames."""
    w = side.wire
    ks = side.keys()
    b1, b2 = side.chain(2)
    vote = side.signed_vote(b1, ks[2][0], ks[2][1])
    timeout = side.signed_timeout(b1.qc, 2, ks[1][0], ks[1][1])
    tc = side.consensus.TC(
        round=3,
        votes=[
            (pk, side.crypto.Signature.new(side.consensus.timeout_digest(3, 1), sk), 1)
            for pk, sk in ks[:3]
        ],
    )
    bodies = [b"body %d" % i * 40 for i in range(6)]
    items = [(side.crypto.Digest.of(b), b) for b in bodies]
    poisoned = (side.crypto.Digest.of(b"other"), b"not the body")
    return [
        w.encode_propose(b2),
        w.encode_vote(vote),
        w.encode_timeout(timeout),
        w.encode_tc(tc),
        w.encode_sync_request(b1.digest(), ks[3][0]),
        w.encode_producer(*items[0]),
        w.encode_producer(*poisoned),
        w.encode_producer(items[1][0]),  # digest only
        w.encode_producer_batch(items[2:] + [poisoned]),
        w.encode_producer(*items[0]),  # replayed body
        b"\x07\x02garbage",  # a malformed state request: dropped
        b"\xff",
        b"",
    ]


async def _handle_all(side: Side, tmp_path, capacity: int) -> dict:
    c = side.consensus
    store = side.store.Store(str(tmp_path / f"bodies-{side.root}"))
    queues = [asyncio.Queue() for _ in range(3)]
    admission = importlib.import_module(f"{side.root}.ingest").AdmissionController(
        capacity=capacity, watermark=1.0, horizon_ms=500, time_fn=lambda: 0.0
    )
    pending = []
    admission.bind(lambda: len(pending), capacity=capacity)
    bodies = importlib.import_module(f"{side.root}.consensus.consensus").PayloadBodies(
        store, budget=1_000
    )
    handler = c.ConsensusReceiverHandler(
        *queues, scheme="ed25519", bodies=bodies, admission=admission
    )
    writer = _Writer()
    try:
        for frame in _frames(side):
            await handler.dispatch(writer, frame)
            while not queues[2].empty():  # the proposer's buffer fills
                pending.append(queues[2].get_nowait())
        out = {"replies": writer.sent, "producer": [d.to_bytes() for d in pending]}
        w = side.wire
        encode = {0: w.encode_propose, 1: w.encode_vote, 2: w.encode_timeout, 3: w.encode_tc}
        out["consensus"] = []
        while not queues[0].empty():
            tag, payload = queues[0].get_nowait()
            out["consensus"].append((tag, encode[tag](payload)))
        out["helper"] = [
            (d.to_bytes(), pk.to_bytes())
            for d, pk in (queues[1].get_nowait() for _ in range(queues[1].qsize()))
        ]
        out["evicted"] = bodies.evicted
        out["stats"] = admission.stats()
    finally:
        store.close()
    with open(os.path.join(tmp_path, f"bodies-{side.root}", "wal.log"), "rb") as f:
        out["wal"] = f.read()
    return out


@pytest.mark.parametrize("capacity", [100, 4])
def test_receiver_handler_matches_jax(tmp_path, capacity):
    """The same frames through the JAX and the port's receiver handler:
    the same ACK and ingest-ACK replies, the same messages to the core,
    helper and proposer, the same bodies stored and evicted under the
    byte budget (byte-equal store logs), the same admission decisions —
    with room, and with a buffer of 4 that sheds."""
    jax = asyncio.run(_handle_all(JAX, tmp_path, capacity))
    port = asyncio.run(_handle_all(PORT, tmp_path, capacity))
    assert port == jax
    assert [tag for tag, _ in port["consensus"]] == [0, 1, 2, 3]
    assert len(port["helper"]) == 1
    if capacity == 100:
        assert len(port["producer"]) == 7 and port["evicted"] > 0
    else:
        assert port["stats"]["shed_total"] > 0


def test_admission_decisions_match_jax():
    """A seeded sequence of commits and admits through both packages'
    AdmissionController on the same clock gives the same decisions."""
    import random

    from hotstuff_tpu.ingest import AdmissionController as JAdmission
    from hotstuff_tpu_torch.ingest import AdmissionController

    rng = random.Random(5)
    now = [0.0]
    occupancy = [0]
    pair = [cls(capacity=500, time_fn=lambda: now[0]) for cls in (JAdmission, AdmissionController)]
    for a in pair:
        a.bind(lambda: occupancy[0])
    for _ in range(400):
        now[0] += rng.random() * 0.05
        occupancy[0] = rng.randrange(0, 520)
        if rng.random() < 0.4:
            n = rng.randrange(0, 80)
            for a in pair:
                a.on_committed(n)
        req = rng.randrange(0, 200)
        j, p = (a.admit(req) for a in pair)
        assert tuple(p) == tuple(j) and p.busy == j.busy
    assert pair[0].stats() == pair[1].stats()


def test_ingest_ack_and_schedule_links_match_jax():
    """The wire frames this slice adds: the producer ingest ACK and the
    store form of the certified schedule links, byte-equal with the JAX
    package both ways, with the same rejections."""
    from hotstuff_tpu.consensus import wire as jw
    from hotstuff_tpu.utils.codec import CodecError as JCodecError
    from hotstuff_tpu_torch.consensus import wire as pw
    from hotstuff_tpu_torch.utils.codec import CodecError

    for args in [(0, 0, 0, 0), (5, 0, 64, 0), (0, 9, 3, 250), (2**40, -1, 7, 10**12)]:
        frame = pw.encode_ingest_ack(*args)
        assert frame == jw.encode_ingest_ack(*args)
        mine, theirs = pw.decode_ingest_ack(frame), jw.decode_ingest_ack(frame)
        for attr in ("status", "accepted", "shed", "credit", "retry_after_ms", "busy"):
            assert getattr(mine, attr) == getattr(theirs, attr)
    assert pw.decode_ingest_ack(b"Ack") is None and pw.INGEST_ACK_TAG == jw.INGEST_ACK_TAG
    good = pw.encode_ingest_ack(1, 0, 2, 0)
    for bad in (good[:-1], good + b"\x00", good[:1] + b"\x09" + good[2:], good[:2] + b"\x05" + good[3:]):
        with pytest.raises(PORT.errors.SerializationError):
            pw.decode_ingest_ack(bad)
        with pytest.raises(JAX.errors.SerializationError):
            jw.decode_ingest_ack(bad)

    links = [(b"block %d" % i * (i + 1), b"qc %d" % i) for i in range(5)]
    data = pw.encode_schedule_links(links)
    assert data == jw.encode_schedule_links(links)
    assert pw.decode_schedule_links(data) == jw.decode_schedule_links(data) == links
    assert pw.MAX_SCHEDULE_LINKS == jw.MAX_SCHEDULE_LINKS
    too_many = pw.encode_schedule_links([(b"b", b"q")] * (pw.MAX_SCHEDULE_LINKS + 1))
    with pytest.raises(CodecError):
        pw.decode_schedule_links(too_many)
    with pytest.raises(JCodecError):
        jw.decode_schedule_links(too_many)


def test_unported_transports_raise(tmp_path):
    """Every transport of the JAX package is ported: ``"sim"`` outside a
    sim run, with no ``SimNet`` installed, raises in both packages alike
    (``tests/test_torch_sim.py`` spawns on one)."""

    async def body(side):
        store = side.store.Store(str(tmp_path / side.root))
        name, secret = side.keys()[0]
        try:
            with pytest.raises(RuntimeError, match="no SimNet installed"):
                await side.consensus.Consensus.spawn(
                    name, side.committee(range(7000, 7004)), side.consensus.Parameters(),
                    side.crypto.SignatureService(secret), store, asyncio.Queue(),
                    transport="sim",
                )
        finally:
            store.close()

    for side in (JAX, PORT):
        asyncio.run(body(side))


# ---- the handler's state-sync routes and state reads ----------------------


def _state_store(path):
    """A store written by the JAX package: a chain of 6 blocks applied,
    two of them with typed-op bodies."""
    from hotstuff_tpu.store import Store as JStore
    from hotstuff_tpu.store.state import OP_BODY_OFFSET, StateMachine, encode_ops

    store = JStore(str(path))
    blocks = JAX.chain(6)
    for i, ops in ((1, [("put", b"user", b"v1"), ("put", b"gone", b"x")]), (4, [("del", b"gone")])):
        store.engine.put(
            b"p" + blocks[i].payloads[0].to_bytes(),
            bytes(OP_BODY_OFFSET) + encode_ops(ops),
        )
    sm = StateMachine(store)
    for b in blocks:
        sm.apply_block(b)
    store.close()
    return [b.payloads[0].to_bytes() for b in blocks]


async def _reads(side: Side, path, ledger_keys) -> list[bytes]:
    w = side.wire
    store = side.store.Store(str(path))
    try:
        sm = importlib.import_module(f"{side.root}.store.state").StateMachine(store)
        writer = _Writer()
        for state in (sm, None):
            handler = side.consensus.ConsensusReceiverHandler(
                asyncio.Queue(), asyncio.Queue(), asyncio.Queue(), state=state
            )
            for key in ledger_keys + [bytes(32)]:
                await handler.dispatch(writer, w.encode_state_read(w.STATE_READ_LEDGER, key))
            for key in (b"user", b"gone", b"never"):
                await handler.dispatch(writer, w.encode_state_read(w.STATE_READ_USER, key))
        return writer.sent
    finally:
        store.close()


def test_state_read_replies_match_jax(tmp_path):
    """``TAG_STATE_READ`` through both packages' handlers over the same
    store: byte-equal replies for ledger hits and misses, a live, a
    deleted and a never-written user key, and from a handler without an
    execution layer."""
    keys = _state_store(tmp_path / "db")
    port = asyncio.run(_reads(PORT, tmp_path / "db", keys))
    assert port == asyncio.run(_reads(JAX, tmp_path / "db", keys))
    replies = [PORT.wire.decode_state_value(r) for r in port]
    assert [r.found for r in replies[:10]] == [True] * 6 + [False, True, False, False]
    assert replies[0].entry_round == 1 and replies[0].value == bytes(4)
    assert replies[7].value == b"v1" and replies[7].state_version == 6
    assert not any(r.found for r in replies[10:])


def _state_frames(side: Side) -> list[bytes]:
    w = side.wire
    ks = side.keys()
    qc = side.qc_for_block(side.chain(2)[-1])
    return [
        w.encode_state_request(w.STATE_REQ_MANIFEST, ks[1][0]),
        w.encode_state_request(w.STATE_REQ_CHUNK, ks[2][0], index=3, from_round=7),
        w.encode_state_manifest(4, bytes(range(32)), 2, 9, 1, 0, qc, ks[1][0]),
        w.encode_state_chunk(4, 0, 0, [(b"s/l" + bytes(32), bytes(12))]),
        w.encode_state_chunk(4, 1, 0, []),  # the reply queue is full: shed
        b"\x07\x02\x09",  # an invalid request kind: dropped
    ]


async def _route(side: Side, with_queues: bool) -> dict:
    queues = [asyncio.Queue() for _ in range(3)]
    requests, replies = asyncio.Queue(), asyncio.Queue(maxsize=2)
    handler = side.consensus.ConsensusReceiverHandler(
        *queues,
        tx_state_requests=requests if with_queues else None,
        tx_state_sync=replies if with_queues else None,
    )
    writer = _Writer()
    for frame in _state_frames(side):
        await handler.dispatch(writer, frame)
    from .test_torch_state import _norm as norm

    return {
        "requests": [norm(requests.get_nowait()) for _ in range(requests.qsize())],
        "replies": [(tag, norm(p)) for tag, p in (replies.get_nowait() for _ in range(replies.qsize()))],
        "others": [q.qsize() for q in queues],
        "sent": writer.sent,
    }


@pytest.mark.parametrize("with_queues", [True, False], ids=["sync-node", "bare-handler"])
def test_state_sync_tags_routed_like_jax(with_queues):
    """Tag 7 goes to the state-sync server's queue, tags 8 and 9 to the
    sync client's (shed when full), nothing to the core, helper or
    proposer and no reply — the same in both packages; a handler built
    without the queues drops them."""
    port = asyncio.run(_route(PORT, with_queues))
    assert port == asyncio.run(_route(JAX, with_queues))
    assert port["others"] == [0, 0, 0] and port["sent"] == []
    if with_queues:
        assert [dict(r)["kind"] for r in port["requests"]] == [0, 1]
        assert [tag for tag, _ in port["replies"]] == [8, 9]
    else:
        assert port["requests"] == port["replies"] == []
