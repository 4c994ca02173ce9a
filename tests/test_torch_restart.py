"""A committed block applied with one write: the port's repair of the
execution layer's write path, which phase (d) of ``chip_smoke.py`` (a
64-node committee with a crash and recovery) runs on every commit.

``StateMachine.apply_block`` (the reference's, ``store/state.py``)
writes one WAL record a payload of the block, and the native engine
makes each put one ``write(2)``: up to 512 system calls a block on each
node.  The port applies the block inside the engine's ``batch()``,
whose records ``hs_put_many`` (``store/csrc/store_batch.cpp``) appends
with one call.  Held here: the WAL bytes and the state after full
blocks equal the JAX package's, made one put at a time; a block is one
append and no single put; a batch reads its own writes, keeps them
when its block raises and refuses a malformed blob whole; and a 4-node
``run_committee`` with a crash and recovery on short timers passes
phase (d)'s checks with every block applied in one batch.

Every listener port comes from the OS (``run_committee`` reserves
them); every run has a bounded load window."""

import os

import numpy as np
import pytest

from hotstuff_tpu_torch.bench.committee import run_committee
from hotstuff_tpu_torch.consensus.messages import MAX_BLOCK_PAYLOADS
from hotstuff_tpu_torch.store import native as pnative
from hotstuff_tpu_torch.store import state as pstate

from .test_torch_core import JAX, PORT
from .test_torch_state import _state, _wal


class _CountingLib:
    """The store library with its ``hs_put`` and ``hs_put_many`` calls
    counted."""

    def __init__(self, lib):
        self._lib = lib
        self.calls = {"hs_put": 0, "hs_put_many": 0}

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self.calls:
            return fn

        def counted(*args):
            self.calls[name] += 1
            return fn(*args)

        return counted


def _full_blocks(side, store, rng, blocks: int = 3):
    """``blocks`` blocks of ``MAX_BLOCK_PAYLOADS`` payloads; a tenth of
    the payloads have typed-op bodies in the store over a small key
    space (a key put and deleted in one block included)."""
    c = side.consensus
    authors = [pk for pk, _ in side.keys()]
    out = []
    for b in range(blocks):
        payloads = []
        for i in range(MAX_BLOCK_PAYLOADS):
            if i % 10 == 0:
                key = b"key-%d" % int(rng.integers(0, 6))
                ops = [("put", key, rng.bytes(int(rng.integers(0, 16))))]
                if rng.random() < 0.3:
                    ops.append(("del", key))
                body = rng.bytes(pstate.OP_BODY_OFFSET) + _state(side).encode_ops(ops)
                digest = side.crypto.Digest.of(body)
                store.engine.put(b"p" + digest.to_bytes(), body)
            else:
                digest = side.crypto.Digest(rng.bytes(32))
            payloads.append(digest)
        out.append(c.Block(qc=c.QC.genesis(), tc=None, author=authors[b % 4], round=2 * b + 1,
                           payloads=tuple(payloads)))
    return out


def test_a_full_block_is_one_append_and_the_references_bytes(tmp_path):
    runs = {}
    for side in (JAX, PORT):
        path = tmp_path / side.root
        store = side.store.Store(str(path))
        sm = _state(side).StateMachine(store)
        blocks = _full_blocks(side, store, np.random.default_rng(3))
        if side is PORT:
            assert isinstance(store.engine, pnative.NativeEngine)
            lib = store.engine._lib = _CountingLib(store.engine._lib)
        roots = [sm.apply_block(b) for b in blocks]
        items = sorted((k, store.engine.get(k)) for k in store.engine.keys() if k.startswith(b"s/"))
        store.close()
        runs[side.root] = (roots, sm.root, sm.version, sm.typed_ops, items, _wal(path))
    assert runs["hotstuff_tpu_torch"] == runs["hotstuff_tpu"]
    assert lib.calls == {"hs_put": 0, "hs_put_many": 3}


def test_the_batch_reads_its_own_writes_and_keeps_them_on_an_error(tmp_path):
    path = str(tmp_path / "db")
    engine = pnative.NativeEngine(path)
    engine.put(b"old", b"1")
    lib = engine._lib = _CountingLib(engine._lib)
    with pytest.raises(ValueError):
        with engine.batch():
            engine.put(b"a", b"x")
            assert engine.get(b"a") == b"x" and engine.get(b"old") == b"1"
            engine.delete(b"a")
            engine.delete(b"old")
            assert engine.get(b"a") is None and engine.get(b"old") is None
            engine.put(b"b", b"")
            assert engine.get(b"b") == b""
            with pytest.raises(RuntimeError, match="not reentrant"):
                with engine.batch():
                    pass
            raise ValueError("the block failed")
    assert (engine.get(b"a"), engine.get(b"old"), engine.get(b"b")) == (None, None, b"")
    assert sorted(engine.keys()) == [b"b"] and lib.calls == {"hs_put": 0, "hs_put_many": 1}
    wal = engine.wal_bytes()
    engine.close()
    # the log replays to the same index, as the one-by-one calls' would
    again = pnative.NativeEngine(path)
    assert sorted(again.keys()) == [b"b"] and again.wal_bytes() == wal == os.path.getsize(
        os.path.join(path, "wal.log"))
    again.close()


@pytest.mark.parametrize("blob", [b"\x01\x00\x00", b"\x04\x00\x00\x00\x02\x00\x00\x00keyv",
                                  b"\x01\x00\x00\x00\x00\x00\x00\x00k\x09"],
                         ids=["short-header", "short-value", "trailing-byte"])
def test_a_malformed_batch_writes_nothing(tmp_path, blob):
    engine = pnative.NativeEngine(str(tmp_path / "db"))
    engine.put(b"k", b"v")
    before = engine.wal_bytes()
    assert engine._lib.hs_put_many(engine._h, blob, len(blob)) == -1
    assert engine.wal_bytes() == before and sorted(engine.keys()) == [b"k"]
    engine.close()


def test_a_crashed_node_recovers_with_every_block_one_batch(monkeypatch):
    """Phase (d)'s committee at 4 nodes on the CPU with short timers (as
    the README's rehearsal runs it): node 1 stops 1 s into the load and
    comes back once the others are 16 rounds past it; it adopts a
    snapshot at least 8 rounds ahead, logs its cursor's advance, commits
    5 blocks after the restart, and the chains, roots and ledger reads
    agree; and every block any node applied was applied inside one
    batch, written with one append."""
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setenv("HOTSTUFF_FORCE_CPU_ROUTE", "1")
    applied, batched, outside = [0], [0], [0]
    apply = pstate.StateMachine._apply
    write_held = pnative.NativeEngine._write_held

    def counted_apply(self, engine, block, reported_digest):
        applied[0] += 1
        outside[0] += engine._records is None
        return apply(self, engine, block, reported_digest)

    def counted_write(self):
        batched[0] += bool(self._records)
        return write_held(self)

    monkeypatch.setattr(pstate.StateMachine, "_apply", counted_apply)
    monkeypatch.setattr(pnative.NativeEngine, "_write_held", counted_write)
    r = run_committee(
        nodes=4, rate=200, duration=12, verifier="cuda", device="cpu", timeout_delay=200,
        sync_retry_delay=200,
        restart={"node": 1, "down_at_s": 1.0, "behind_rounds": 16, "deadline_s": 6.0},
    )
    sync = r["state_sync"]
    assert sync["adopted"] and sync["entries"] > 0
    assert sync["round"] >= sync["cursor_at_stop"] + 8
    assert sync["cursor_advanced"] == (sync["cursor_at_stop"], sync["round"])
    assert sync["blocks_after"] >= 5 and min(r["blocks"]) >= 5
    assert r["chains_agree"] and r["roots_agree"]
    reads = r["ledger_reads"]
    assert reads["reads"] > 0 and reads["matched"] == reads["reads"]
    versions = sum(len(roots) for roots in r["state_roots"])
    assert applied[0] >= versions > 0 and outside[0] == 0 and batched[0] >= applied[0]
