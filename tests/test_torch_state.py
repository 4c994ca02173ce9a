"""The port's execution layer and state frames against the JAX package's:
the counterparts of tests/test_state.py on ``hotstuff_tpu_torch``; a
seeded run of 200 blocks, some with typed-op bodies, through a JAX and a
port ``StateMachine`` giving the same cursor, roots and counters after
every block and byte-equal WAL files; equal snapshot manifests and
chunks; snapshots adopted across the packages giving equal stores; and
the op codec and the state frames decoding arbitrary bytes to equal
values in both packages, or raising in both."""

import importlib
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hotstuff_tpu_torch.consensus.errors import SerializationError
from hotstuff_tpu_torch.consensus.wire import (
    MAX_STATE_CHUNK_ENTRIES,
    STATE_READ_LEDGER,
    STATE_READ_USER,
    STATE_REQ_CHUNK,
    STATE_REQ_DELTA,
    STATE_REQ_MANIFEST,
    STATE_VALUE_TAG,
    TAG_STATE_CHUNK,
    TAG_STATE_MANIFEST,
    TAG_STATE_READ,
    TAG_STATE_REQUEST,
    decode_message,
    decode_state_value,
    encode_state_chunk,
    encode_state_manifest,
    encode_state_read,
    encode_state_request,
    encode_state_value,
)
from hotstuff_tpu_torch.crypto import Digest
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.store.state import (
    GENESIS_ROOT,
    MAX_OPS_PER_BODY,
    OP_BODY_OFFSET,
    OP_MAGIC,
    SNAPSHOT_CHUNK_ENTRIES,
    SnapshotManifest,
    StateError,
    StateMachine,
    decode_ops,
    encode_ops,
    fold_root,
)

from .test_torch_core import JAX, PORT

BLOCKS = 200


def _store(tmp_path, name: str) -> Store:
    return Store(str(tmp_path / name))


def _typed_body(ops) -> bytes:
    """A payload body as the ingest plane stores it: the 8-byte producer
    counter prefix, then the typed-op blob."""
    return b"\x00" * OP_BODY_OFFSET + encode_ops(ops)


def _random_digest(rng) -> Digest:
    return Digest(rng.bytes(Digest.SIZE))


def _state(side):
    return importlib.import_module(f"{side.root}.store.state")


# ---- counterparts of tests/test_state.py: typed-op codec -------------------


def test_ops_codec_roundtrip():
    ops = [
        ("put", b"alpha", b"1"),
        ("del", b"beta"),
        ("put", b"gamma", b""),
        ("put", b"k" * 256, b"v" * 4096),
    ]
    body = _typed_body(ops)
    assert decode_ops(body) == ops
    assert decode_ops(_typed_body([])) == []


def test_decode_ops_rejects_malformed():
    assert decode_ops(b"\x00" * OP_BODY_OFFSET + b"not-typed") is None
    assert decode_ops(b"") is None

    good = _typed_body([("put", b"key", b"value")])
    for cut in range(OP_BODY_OFFSET + len(OP_MAGIC) + 1, len(good)):
        assert decode_ops(good[:cut]) is None

    prefix = b"\x00" * OP_BODY_OFFSET + OP_MAGIC
    assert decode_ops(prefix + bytes([0, 0, 0, 0, 0, 0, 0])) is None
    assert decode_ops(prefix + bytes([7, 1, 0, 0, 0, 0, 0]) + b"k") is None
    assert decode_ops(prefix + bytes([1, 1, 0, 1, 0, 0, 0]) + b"k") is None
    too_many = _typed_body([("put", b"k", b"v")] * (MAX_OPS_PER_BODY + 1))
    assert decode_ops(too_many) is None
    at_cap = _typed_body([("put", b"k", b"v")] * MAX_OPS_PER_BODY)
    assert len(decode_ops(at_cap)) == MAX_OPS_PER_BODY
    with pytest.raises(StateError):
        encode_ops([("inc", b"k")])


def test_fold_root_accepts_bytes_and_digest():
    rng = np.random.default_rng(1)
    d = _random_digest(rng)
    block = rng.bytes(32)
    via_digest = fold_root(GENESIS_ROOT, 7, block, [d])
    via_bytes = fold_root(GENESIS_ROOT, 7, block, [d.to_bytes()])
    assert via_digest == via_bytes
    assert via_digest != GENESIS_ROOT
    assert fold_root(GENESIS_ROOT, 8, block, [d]) != via_digest


# ---- deterministic apply ---------------------------------------------------


def test_apply_is_deterministic_across_replicas(tmp_path):
    blocks = PORT.chain(5)
    sm_a = StateMachine(_store(tmp_path, "a"))
    sm_b = StateMachine(_store(tmp_path, "b"))
    for block in blocks:
        assert sm_a.apply_block(block) == sm_b.apply_block(block)
    assert sm_a.version == sm_b.version == len(blocks)
    assert sm_a.root == sm_b.root
    assert sm_a.reported_root == sm_a.root
    assert sm_a.last_round == blocks[-1].round


def test_reported_root_diverges_under_shadow_digest(tmp_path):
    blocks = PORT.chain(3)
    honest = StateMachine(_store(tmp_path, "honest"))
    collude = StateMachine(_store(tmp_path, "collude"))
    for block in blocks[:-1]:
        honest.apply_block(block)
        collude.apply_block(block)
    honest.apply_block(blocks[-1])
    collude.apply_block(
        blocks[-1], reported_digest=_random_digest(np.random.default_rng(2))
    )
    assert collude.root == honest.root
    assert collude.reported_root != honest.reported_root


def test_apply_skips_already_applied_rounds(tmp_path):
    blocks = PORT.chain(2)
    sm = StateMachine(_store(tmp_path, "db"))
    assert sm.apply_block(blocks[0]) is not None
    before = (sm.version, sm.root, sm.applied_payloads)
    assert sm.apply_block(blocks[0]) is None
    assert (sm.version, sm.root, sm.applied_payloads) == before
    assert sm.apply_block(blocks[1]) is not None
    assert sm.version == 2


def test_meta_persists_across_reopen(tmp_path):
    store = _store(tmp_path, "db")
    sm = StateMachine(store)
    for block in PORT.chain(4):
        sm.apply_block(block)
    anchor = sm.anchor()
    reported = sm.reported_root
    store.close()

    sm2 = StateMachine(_store(tmp_path, "db"))
    assert sm2.anchor() == anchor
    assert sm2.reported_root == reported
    assert sm2.applied_payloads == sm.applied_payloads


# ---- typed ops and the read path -------------------------------------------


def test_typed_ops_materialize_user_state(tmp_path):
    store = _store(tmp_path, "db")
    blocks = PORT.chain(3)
    body0 = _typed_body([("put", b"user", b"v1")])
    body1 = _typed_body([("put", b"user", b"v2"), ("del", b"gone")])
    store.engine.put(b"p" + blocks[0].payloads[0].to_bytes(), body0)
    store.engine.put(b"p" + blocks[1].payloads[0].to_bytes(), body1)

    sm = StateMachine(store)
    for block in blocks:
        sm.apply_block(block)

    round_, value = sm.read_user(b"user")
    assert value == b"v2"
    assert round_ == blocks[1].round
    assert sm.read_user(b"gone") is None
    assert sm.read_user(b"never") is None
    assert sm.typed_ops == 3
    for block in blocks:
        assert sm.read_ledger(block.payloads[0].to_bytes()) == (block.round, 0)
    assert sm.read_ledger(bytes(32)) is None
    stats = sm.stats()
    assert (stats["version"], stats["typed_ops"], stats["applied_blocks"]) == (3, 3, 3)


# ---- snapshots -------------------------------------------------------------


def test_snapshot_roundtrip_into_fresh_store(tmp_path):
    src_store = _store(tmp_path, "src")
    blocks = PORT.chain(6)
    src_store.engine.put(
        b"p" + blocks[2].payloads[0].to_bytes(),
        _typed_body([("put", b"carried", b"over")]),
    )
    src = StateMachine(src_store)
    for block in blocks:
        src.apply_block(block)

    manifest = src.manifest()
    assert manifest.version == src.version
    assert manifest.root == src.root
    entries = []
    for index in range(manifest.chunk_count):
        chunk = src.chunk(index)
        assert 0 < len(chunk) <= SNAPSHOT_CHUNK_ENTRIES
        entries.extend(chunk)

    dst = StateMachine(_store(tmp_path, "dst"))
    dst.adopt(manifest, entries)
    assert dst.anchor() == src.anchor()
    assert dst.reported_root == src.root
    assert dst.synced_from_snapshot
    assert dst.read_user(b"carried") == src.read_user(b"carried")
    for block in blocks:
        digest = block.payloads[0].to_bytes()
        assert dst.read_ledger(digest) == src.read_ledger(digest)


def test_delta_entries_filter_by_round(tmp_path):
    sm = StateMachine(_store(tmp_path, "db"))
    blocks = PORT.chain(6)
    for block in blocks:
        sm.apply_block(block)
    cut = blocks[3].round
    full = sm._entries()
    delta = sm._entries(from_round=cut)
    assert len(full) == len(blocks)
    assert len(delta) == len([b for b in blocks if b.round > cut])
    assert set(delta) <= set(full)
    for _, value in delta:
        assert int.from_bytes(value[:8], "little") > cut
    assert sm.manifest(from_round=cut).version == sm.version


def test_adopt_rejects_entries_outside_state_namespace(tmp_path):
    sm = StateMachine(_store(tmp_path, "db"))
    manifest = SnapshotManifest(1, bytes(range(32)), 1, 0, 1)
    with pytest.raises(StateError):
        sm.adopt(manifest, [(b"p" + b"\x00" * 32, b"smuggled body")])
    with pytest.raises(StateError):
        sm.adopt(manifest, [(b"s/meta", b"cursor overwrite")])
    assert sm.version == 0
    assert sm.root == GENESIS_ROOT
    assert "chunks=1" in repr(manifest)


# ---- state wire frames -----------------------------------------------------


def test_state_request_wire_roundtrip():
    origin = PORT.keys()[0][0]
    for kind in (STATE_REQ_MANIFEST, STATE_REQ_CHUNK, STATE_REQ_DELTA):
        frame = encode_state_request(kind, origin, index=3, from_round=17)
        tag, msg = decode_message(frame)
        assert tag == TAG_STATE_REQUEST
        assert (msg.kind, msg.index, msg.from_round) == (kind, 3, 17)
        assert msg.origin == origin


def test_state_manifest_wire_roundtrip():
    block = PORT.chain(2)[-1]
    qc = PORT.qc_for_block(block)
    origin = PORT.keys()[1][0]
    root = bytes(range(32))
    frame = encode_state_manifest(9, root, block.round, 42, 2, 5, qc, origin)
    tag, msg = decode_message(frame)
    assert tag == TAG_STATE_MANIFEST
    assert (msg.version, msg.root, msg.last_round) == (9, root, block.round)
    assert (msg.applied_payloads, msg.chunk_count, msg.from_round) == (42, 2, 5)
    assert msg.qc.hash == qc.hash and msg.qc.round == qc.round
    assert msg.origin == origin and msg.links == ()


def test_state_chunk_wire_roundtrip_and_cap():
    entries = [(b"s/l" + bytes([i]) * 32, bytes(8) + bytes([i])) for i in range(5)]
    frame = encode_state_chunk(4, 1, 10, entries)
    tag, msg = decode_message(frame)
    assert tag == TAG_STATE_CHUNK
    assert (msg.version, msg.index, msg.from_round) == (4, 1, 10)
    assert list(msg.entries) == entries
    assert decode_message(encode_state_chunk(1, 0, 0, []))[1].entries == ()
    with pytest.raises(ValueError):
        encode_state_chunk(1, 0, 0, [(b"k", b"v")] * (MAX_STATE_CHUNK_ENTRIES + 1))


def test_state_read_wire_roundtrip():
    for space in (STATE_READ_LEDGER, STATE_READ_USER):
        tag, msg = decode_message(encode_state_read(space, b"some-key"))
        assert tag == TAG_STATE_READ
        assert msg == (space, b"some-key")
    bad = bytearray(encode_state_read(STATE_READ_USER, b"k"))
    bad[2] = 99
    with pytest.raises(SerializationError):
        decode_message(bytes(bad))


def test_state_value_reply_roundtrip():
    root = bytes(range(32))
    frame = encode_state_value(True, 11, root, 13, 9, b"payload-value")
    reply = decode_state_value(frame)
    assert reply.found is True
    assert (reply.state_version, reply.root) == (11, root)
    assert (reply.last_round, reply.entry_round) == (13, 9)
    assert reply.value == b"payload-value"
    assert frame[0] == STATE_VALUE_TAG
    assert decode_state_value(b"Ack") is None
    assert decode_state_value(b"") is None
    miss = decode_state_value(encode_state_value(False, 11, root, 13, 0, b""))
    assert miss.found is False and miss.value == b""
    with pytest.raises(SerializationError):
        decode_state_value(frame[:-1])


# ---- the port against the JAX package --------------------------------------


def _seeded_run(side, tmp_path, seed: int = 6):
    """Apply ``BLOCKS`` seeded blocks through ``side``'s StateMachine.
    Each block carries 0-4 payload digests; about a third of the
    payloads have a body in the store, most of those typed put/del ops
    over a small key space, the rest opaque.  Returns the machine, its
    store path and the observed tuple after every block."""
    rng = np.random.default_rng(seed)
    path = tmp_path / f"run-{side.root}"
    store = side.store.Store(str(path))
    sm = _state(side).StateMachine(store)
    c = side.consensus
    authors = [pk for pk, _ in side.keys()]
    seen = []
    round_ = 0
    for i in range(BLOCKS):
        round_ += 1 + int(rng.integers(0, 3))  # view changes leave gaps
        payloads = []
        for _ in range(int(rng.integers(0, 5))):
            kind = rng.random()
            if kind < 0.25:
                ops = []
                for _ in range(int(rng.integers(1, 4))):
                    key = b"key-%d" % int(rng.integers(0, 12))
                    if rng.random() < 0.7:
                        ops.append(("put", key, rng.bytes(int(rng.integers(0, 24)))))
                    else:
                        ops.append(("del", key))
                body = rng.bytes(OP_BODY_OFFSET) + _state(side).encode_ops(ops)
            elif kind < 0.35:
                body = rng.bytes(int(rng.integers(8, 64)))
            else:
                body = None
            if body is None:
                digest = side.crypto.Digest(rng.bytes(32))
            else:
                digest = side.crypto.Digest.of(body)
                store.engine.put(b"p" + digest.to_bytes(), body)
            payloads.append(digest)
        block = c.Block(
            qc=c.QC.genesis(), tc=None, author=authors[i % 4], round=round_,
            payloads=tuple(payloads),
        )
        reported = sm.apply_block(block)
        seen.append((
            block.digest().to_bytes(), reported, sm.version, sm.root,
            sm.reported_root, sm.last_round, sm.applied_payloads, sm.typed_ops,
        ))
    return sm, store, path, seen


def _wal(path) -> bytes:
    with open(os.path.join(path, "wal.log"), "rb") as f:
        return f.read()


def _state_items(engine) -> list:
    return sorted((k, engine.get(k)) for k in engine.keys() if k.startswith(b"s/"))


def test_seeded_blocks_give_equal_roots_and_wal_files(tmp_path):
    """200 seeded blocks with typed and opaque bodies: after every block
    both packages' machines hold the same version, root, reported root,
    last round and counters, and their WAL files are byte-equal."""
    j_sm, j_store, j_path, j_seen = _seeded_run(JAX, tmp_path)
    p_sm, p_store, p_path, p_seen = _seeded_run(PORT, tmp_path)
    try:
        assert p_seen == j_seen
        assert p_sm.typed_ops > 20 and p_sm.applied_payloads > 300
        assert p_sm.stats() == j_sm.stats()
        j_store.close()
        p_store.close()
        assert _wal(p_path) == _wal(j_path)
    finally:
        j_store.close()
        p_store.close()


@pytest.mark.parametrize("from_round", [0, 57])
def test_manifest_and_chunks_match_jax(tmp_path, from_round):
    """Full and delta snapshots of the same seeded state: equal manifests
    and, chunk by chunk, equal entries."""
    j_sm, j_store, _, _ = _seeded_run(JAX, tmp_path)
    p_sm, p_store, _, _ = _seeded_run(PORT, tmp_path)
    try:
        jm, pm = j_sm.manifest(from_round), p_sm.manifest(from_round)
        fields = ("version", "root", "last_round", "applied_payloads", "chunk_count")
        assert [getattr(pm, f) for f in fields] == [getattr(jm, f) for f in fields]
        assert pm.chunk_count >= 2
        for index in range(pm.chunk_count + 1):  # one past the end: empty
            assert p_sm.chunk(index, from_round) == j_sm.chunk(index, from_round)
    finally:
        j_store.close()
        p_store.close()


@pytest.mark.parametrize("server,client", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_adopt_across_packages_gives_equal_stores(tmp_path, server, client):
    """A full snapshot served by one package and adopted by the other:
    the adopter's state entries and cursor equal the server's, and the
    adopter's store log equals the one the server's own package writes
    adopting the same chunks."""
    src, src_store, _, _ = _seeded_run(server, tmp_path)
    try:
        m = src.manifest()
        entries = [e for i in range(m.chunk_count) for e in src.chunk(i)]
        logs = {}
        for side in (client, server):
            path = tmp_path / f"adopt-{side.root}"
            store = side.store.Store(str(path))
            dst = _state(side).StateMachine(store)
            dst.adopt(
                _state(side).SnapshotManifest(
                    m.version, m.root, m.last_round, m.applied_payloads, m.chunk_count
                ),
                entries,
            )
            assert dst.anchor() == src.anchor()
            assert _state_items(store.engine) == _state_items(src_store.engine)
            store.close()
            reopened = side.store.Store(str(path))
            try:
                assert _state(side).StateMachine(reopened).anchor() == src.anchor()
            finally:
                reopened.close()
            logs[side.root] = _wal(path)
        assert logs[client.root] == logs[server.root]
    finally:
        src_store.close()


# ---- decoding arbitrary bytes in both packages ------------------------------


def _norm(value):
    """A comparable form of a decoded value of either package."""
    if isinstance(value, (list, tuple)):
        return tuple(_norm(v) for v in value)
    if isinstance(value, (bytes, int, str, type(None), bool)):
        return value
    if hasattr(value, "to_bytes") and hasattr(value, "data"):
        return value.to_bytes()
    if hasattr(value, "encode") and hasattr(value, "votes"):  # a QC
        enc = importlib.import_module(
            type(value).__module__.rsplit(".", 2)[0] + ".utils.codec"
        ).Encoder()
        value.encode(enc)
        return enc.finish()
    return tuple((s, _norm(getattr(value, s))) for s in type(value).__slots__)


def _outcome(fn, data):
    try:
        return "ok", _norm(fn(data))
    except Exception as e:  # noqa: BLE001 — the kind is compared
        return "raised", type(e).__name__


def _valid_state_frames():
    """Well-formed frames of tags 7-10 built with the JAX encoder, for the
    fuzzer to cut and flip."""
    from hotstuff_tpu.consensus import wire as jw

    ks = JAX.keys()
    block = JAX.chain(2)[-1]
    qc = JAX.qc_for_block(block)
    entries = [(b"s/l" + bytes([i]) * 32, bytes(8) + bytes([i])) for i in range(3)]
    return [
        jw.encode_state_request(jw.STATE_REQ_DELTA, ks[0][0], index=2, from_round=9),
        jw.encode_state_manifest(9, bytes(32), 2, 4, 1, 0, qc, ks[1][0],
                                 links=[(b"block", b"qc")]),
        jw.encode_state_chunk(3, 0, 1, entries),
        jw.encode_state_read(jw.STATE_READ_USER, b"key"),
    ]


_FRAMES = _valid_state_frames()


@st.composite
def _state_bytes(draw):
    """Raw bytes under tags 7-10, or a valid frame with a few bytes
    flipped (often still decodable), or one cut short or run on."""
    mode = draw(st.sampled_from(["raw", "flip", "cut"]))
    if mode == "raw":
        return bytes([draw(st.integers(7, 10))]) + draw(st.binary(max_size=200))
    frame = bytearray(draw(st.sampled_from(_FRAMES)))
    if mode == "flip":
        for _ in range(draw(st.integers(0, 3))):
            frame[draw(st.integers(1, len(frame) - 1))] = draw(st.integers(0, 255))
        return bytes(frame)
    cut = draw(st.integers(1, len(frame)))
    return bytes(frame[:cut]) + draw(st.binary(max_size=8))


@settings(max_examples=300, derandomize=True, deadline=None)
@given(_state_bytes(), st.binary(max_size=120))
def test_decoders_agree_with_jax_on_arbitrary_bytes(frame, body):
    """``decode_message`` on arbitrary bytes under tags 7-10 (raw, and
    cut and flipped valid frames), ``decode_state_value`` and
    ``decode_ops`` on arbitrary bytes: the same value in both packages,
    or an error of the same kind in both."""
    from hotstuff_tpu.consensus import wire as jw
    from hotstuff_tpu.store import state as js

    from hotstuff_tpu_torch.store import state as ps

    assert _outcome(decode_message, frame) == _outcome(jw.decode_message, frame)
    value = bytes([STATE_VALUE_TAG]) + frame[1:]
    assert _outcome(decode_state_value, value) == _outcome(jw.decode_state_value, value)
    typed = body[:OP_BODY_OFFSET] + OP_MAGIC + body[OP_BODY_OFFSET:]
    for data in (body, typed):
        assert _outcome(ps.decode_ops, data) == _outcome(js.decode_ops, data)
