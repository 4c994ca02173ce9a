"""The port's store against the JAX package's: the counterparts of
tests/test_store.py on ``hotstuff_tpu_torch.store``, the same
write/read/notify_read/delete sequence through both packages giving
equal reads and byte-equal WAL files, and a store written by either
package opening in the other with the same contents."""

import asyncio
import os
import random

import pytest

from hotstuff_tpu.store import Store as JStore
from hotstuff_tpu.store import WalEngine as JWalEngine
from hotstuff_tpu_torch.store import Store, WalEngine


def run(coro):
    return asyncio.run(coro)


def test_create_store(tmp_path):
    store = Store(str(tmp_path / "db"))
    store.close()


def test_read_write_value(tmp_path):
    async def body():
        store = Store(str(tmp_path / "db"))
        await store.write(b"hello", b"world")
        assert await store.read(b"hello") == b"world"
        store.close()

    run(body())


def test_read_unknown_key(tmp_path):
    async def body():
        store = Store(str(tmp_path / "db"))
        assert await store.read(b"nope") is None
        store.close()

    run(body())


def test_read_notify_existing(tmp_path):
    async def body():
        store = Store(str(tmp_path / "db"))
        await store.write(b"k", b"v")
        assert await store.notify_read(b"k") == b"v"
        store.close()

    run(body())


def test_read_notify_parks_until_write(tmp_path):
    async def body():
        store = Store(str(tmp_path / "db"))
        waiter = asyncio.create_task(store.notify_read(b"later"))
        await asyncio.sleep(0.05)
        assert not waiter.done()
        await store.write(b"later", b"arrived")
        assert await asyncio.wait_for(waiter, 1) == b"arrived"
        # multiple waiters on one key all resolve
        w1 = asyncio.create_task(store.notify_read(b"multi"))
        w2 = asyncio.create_task(store.notify_read(b"multi"))
        await asyncio.sleep(0.05)
        await store.write(b"multi", b"x")
        assert await asyncio.wait_for(asyncio.gather(w1, w2), 1) == [b"x", b"x"]
        # a cancelled notify leaves nothing parked; close cancels the rest
        w3 = asyncio.create_task(store.notify_read(b"never"))
        await asyncio.sleep(0.01)
        store.cancel_notify(b"never")
        with pytest.raises(asyncio.CancelledError):
            await w3
        w4 = asyncio.create_task(store.notify_read(b"closing"))
        await asyncio.sleep(0.01)
        store.close()
        with pytest.raises(asyncio.CancelledError):
            await w4
        with pytest.raises(RuntimeError):
            await store.read(b"k")

    run(body())


def test_persistence_across_reopen(tmp_path):
    path = str(tmp_path / "db")

    async def write_phase():
        store = Store(path)
        for i in range(100):
            await store.write(b"key-%d" % i, b"value-%d" % i)
        await store.read(b"key-0")
        store.close()

    async def read_phase():
        store = Store(path)
        for i in range(100):
            assert await store.read(b"key-%d" % i) == b"value-%d" % i
        store.close()

    run(write_phase())
    run(read_phase())


def test_torn_tail_record_discarded(tmp_path):
    path = str(tmp_path / "db")
    eng = WalEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    # simulate a crash mid-append
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00\x10\x00\x00\x00partial")
    eng2 = WalEngine(path)
    assert eng2.get(b"good") == b"value"
    assert len(eng2) == 1
    eng2.put(b"after", b"crash")
    assert eng2.get(b"after") == b"crash"
    eng2.close()
    # records written after recovery must survive a SECOND reopen
    eng3 = WalEngine(path)
    assert eng3.get(b"good") == b"value"
    assert eng3.get(b"after") == b"crash"
    eng3.close()


def test_torn_tail_every_byte_offset(tmp_path):
    """Crash-chop the log at every byte offset inside the final record:
    replay keeps the complete records, drops the torn one, truncates the
    tail and stays writable — in the port as in the JAX package, which
    must leave the same bytes on disk."""
    key, value = b"final-key", b"final-value!"
    record_len = 8 + len(key) + len(value)
    for cut in range(record_len):
        files = []
        for tag, engine in (("port", WalEngine), ("jax", JWalEngine)):
            path = str(tmp_path / f"{tag}-{cut}")
            eng = engine(path)
            eng.put(b"keep-a", b"1")
            eng.put(b"keep-b", b"2")
            eng.put(key, value)
            eng.close()
            wal = os.path.join(path, "wal.log")
            full = os.path.getsize(wal)
            with open(wal, "ab") as f:
                f.truncate(full - record_len + cut)
            eng2 = engine(path)
            assert eng2.get(b"keep-a") == b"1"
            assert eng2.get(b"keep-b") == b"2"
            assert eng2.get(key) is None
            assert len(eng2) == 2
            eng2.put(b"post", b"crash")
            eng2.close()
            eng3 = engine(path)
            assert eng3.get(b"keep-a") == b"1"
            assert eng3.get(key) is None
            assert eng3.get(b"post") == b"crash"
            eng3.close()
            with open(wal, "rb") as f:
                files.append(f.read())
        assert files[0] == files[1]


def test_torn_tail_delete_record(tmp_path):
    """A torn trailing tombstone must not delete the key it targeted."""
    path = str(tmp_path / "db")
    eng = WalEngine(path)
    eng.put(b"victim", b"alive")
    eng.delete(b"victim")
    eng.close()
    wal = os.path.join(path, "wal.log")
    with open(wal, "ab") as f:
        f.truncate(os.path.getsize(wal) - 1)
    eng2 = WalEngine(path)
    assert eng2.get(b"victim") == b"alive"
    eng2.close()


def test_delete_tombstone_survives_reopen(tmp_path):
    path = str(tmp_path / "db")
    eng = WalEngine(path)
    eng.put(b"a", b"1")
    eng.put(b"b", b"2")
    eng.delete(b"a")
    eng.close()
    eng2 = WalEngine(path)
    assert eng2.get(b"a") is None
    assert eng2.get(b"b") == b"2"
    assert sorted(eng2.keys()) == [b"b"]
    eng2.close()


def test_overwrite_uses_latest(tmp_path):
    path = str(tmp_path / "db")
    eng = WalEngine(path)
    eng.put(b"k", b"old")
    eng.put(b"k", b"new")
    eng.close()
    eng2 = WalEngine(path)
    assert eng2.get(b"k") == b"new"
    eng2.close()


def _ops(seed: int, n: int = 300):
    """A seeded sequence of store operations over a small key space, so
    keys are overwritten, deleted and re-written."""
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        key = b"key-%d" % rng.randrange(40)
        kind = rng.choice(("write", "write", "write", "read", "delete", "notify"))
        value = rng.randbytes(rng.randrange(0, 200)) if kind == "write" else None
        ops.append((kind, key, value))
    return ops


async def _play(store, ops) -> list:
    """Run ``ops`` on ``store``; a notify_read on a missing key parks
    until the next write of that key.  Returns every read's result in
    order."""
    out = []
    parked = []
    for kind, key, value in ops:
        if kind == "write":
            await store.write(key, value)
            await asyncio.sleep(0)  # let parked readers take the value
        elif kind == "read":
            out.append(("read", key, await store.read(key)))
        elif kind == "delete":
            await store.delete(key)
        else:
            parked.append((key, asyncio.ensure_future(store.notify_read(key))))
            await asyncio.sleep(0)
    for key, fut in parked:
        if fut.done():
            out.append(("notify", key, fut.result()))
        else:
            fut.cancel()
            out.append(("notify", key, None))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_sequence_equal_reads_and_files(tmp_path, seed):
    """One seeded write/read/notify_read/delete sequence through the JAX
    ``Store(path, engine=WalEngine(path))`` and the port's ``Store``:
    equal reads, equal parked-read results, byte-equal WAL files, and
    the same contents after a reopen."""
    ops = _ops(seed)
    results, files = [], []
    for tag, store_cls, engine_cls in (
        ("jax", JStore, JWalEngine),
        ("port", Store, WalEngine),
    ):
        path = str(tmp_path / tag)

        async def body():
            store = store_cls(path, engine=engine_cls(path))
            try:
                return await _play(store, ops)
            finally:
                store.close()

        results.append(run(body()))
        with open(os.path.join(path, "wal.log"), "rb") as f:
            files.append(f.read())
    assert results[0] == results[1]
    assert files[0] == files[1] and files[0]
    jax, port = JWalEngine(str(tmp_path / "jax")), WalEngine(str(tmp_path / "port"))
    try:
        assert sorted(jax.keys()) == sorted(port.keys())
        assert all(jax.get(k) == port.get(k) for k in jax.keys())
    finally:
        jax.close()
        port.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_opens_in_the_other_package(tmp_path, writer):
    """A store written by one package (the JAX package's default engine,
    native or Python) opens in the other with the same contents; the
    reader's appends are then read back by the writer."""
    path = str(tmp_path / "db")
    write_store, read_store = (JStore, Store) if writer == "jax" else (Store, JStore)
    ops = _ops(7, 200)

    async def write_phase():
        store = write_store(path)
        try:
            await _play(store, ops)
            return {k: store.engine.get(k) for k in store.engine.keys()}
        finally:
            store.close()

    expected = run(write_phase())

    async def read_phase():
        store = read_store(path)
        try:
            got = {k: await store.read(k) for k in expected}
            assert sorted(store.engine.keys()) == sorted(expected)
            await store.write(b"appended", b"by the reader")
            await store.delete(next(iter(expected)))
        finally:
            store.close()
        return got

    assert run(read_phase()) == expected

    async def back_phase():
        store = write_store(path)
        try:
            assert await store.read(b"appended") == b"by the reader"
            assert await store.read(next(iter(expected))) is None
        finally:
            store.close()

    run(back_phase())
