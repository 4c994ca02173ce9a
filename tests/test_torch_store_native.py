"""The port's native C++ WAL engine against the JAX package's.

The cases of ``tests/test_store_native.py`` on the port's
``NativeEngine`` (its own build of ``native/store_engine.cpp``), then
files across packages and engines: a WAL written by either package's
C++ engine opens in the other package's C++ and Python engines, and one
seeded put/delete sequence leaves byte-equal files in all four engines.
A store library that cannot build raises at ``open_engine`` instead of
opening the Python engine.  Bytes: the tolerance is zero.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hotstuff_tpu.store import engine as jengine
from hotstuff_tpu.store import native as jnative
from hotstuff_tpu_torch import _native_build
from hotstuff_tpu_torch.store import Store, open_engine
from hotstuff_tpu_torch.store.engine import WalEngine
from hotstuff_tpu_torch.store.native import NativeEngine

ROOT = Path(__file__).resolve().parents[1]

ENGINES = {
    "port-native": NativeEngine,
    "port-wal": WalEngine,
    "jax-native": jnative.NativeEngine,
    "jax-wal": jengine.WalEngine,
}


def test_native_put_get_delete_roundtrip(tmp_path):
    e = NativeEngine(str(tmp_path / "db"))
    e.put(b"a", b"1")
    e.put(b"b", b"2" * 1000)
    e.put(b"a", b"3")  # overwrite
    e.delete(b"b")
    assert e.get(b"a") == b"3"
    assert e.get(b"b") is None
    assert e.get(b"missing") is None
    assert len(e) == 1
    assert set(e.keys()) == {b"a"}
    e.put(b"", b"empty-key")  # empty key and value edge cases
    e.put(b"ev", b"")
    assert e.get(b"") == b"empty-key"
    assert e.get(b"ev") == b""
    e.close()


def test_native_reopen_recovers(tmp_path):
    path = str(tmp_path / "db")
    e = NativeEngine(path)
    for i in range(100):
        e.put(f"k{i}".encode(), f"v{i}".encode() * 10)
    e.delete(b"k50")
    e.close()
    e2 = NativeEngine(path)
    assert len(e2) == 99
    assert e2.get(b"k7") == b"v7" * 10
    assert e2.get(b"k50") is None
    e2.close()


def test_cross_engine_wal_interop(tmp_path):
    """The port's Python and C++ engines share the WAL format."""
    path = str(tmp_path / "db")
    w = WalEngine(path)
    w.put(b"py", b"from-python")
    w.delete(b"gone")
    w.close()
    e = NativeEngine(path)
    assert e.get(b"py") == b"from-python"
    e.put(b"cc", b"from-cpp")
    e.close()
    w2 = WalEngine(path)
    assert w2.get(b"py") == b"from-python"
    assert w2.get(b"cc") == b"from-cpp"
    w2.close()


def test_native_torn_tail_truncated(tmp_path):
    """A torn (half-written) trailing record is discarded and truncated."""
    path = str(tmp_path / "db")
    e = NativeEngine(path)
    e.put(b"good", b"value")
    e.close()
    wal = os.path.join(path, "wal.log")
    with open(wal, "ab") as f:
        f.write(struct.pack("<II", 4, 100))  # header promises 100-byte value
        f.write(b"torn")  # ...but the process died here
    e2 = NativeEngine(path)
    assert e2.get(b"good") == b"value"
    assert len(e2) == 1
    e2.close()
    e3 = NativeEngine(path)  # the tail was truncated: an append replays cleanly
    e3.put(b"after", b"recovery")
    e3.close()
    e4 = NativeEngine(path)
    assert e4.get(b"after") == b"recovery"
    assert len(e4) == 2
    e4.close()


_KILL_SCRIPT = r"""
import os, sys
sys.path.insert(0, {root!r})
from hotstuff_tpu_torch.store.native import NativeEngine
e = NativeEngine({path!r}, fsync_mode=1)
for i in range(50):
    e.put(f"key{{i}}".encode(), b"x" * 100)
os.kill(os.getpid(), 9)  # die without close()
"""


def test_native_survives_sigkill(tmp_path):
    """A process killed mid-sequence (no close): every acknowledged put
    is recovered on reopen."""
    path = str(tmp_path / "db")
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT.format(root=str(ROOT), path=path)],
        capture_output=True,
        timeout=60,
    )
    assert proc.returncode == -9  # SIGKILL
    e = NativeEngine(path)
    assert len(e) == 50
    for i in range(50):
        assert e.get(f"key{i}".encode()) == b"x" * 100
    e.close()


def test_native_compaction_bounds_wal(tmp_path):
    """Overwriting the same keys grows the log; reopen compacts it."""
    path = str(tmp_path / "db")
    e = NativeEngine(path)
    for round_ in range(300):
        for k in range(10):
            e.put(f"key{k}".encode(), bytes([round_ % 256]) * 1024)
    grown = e.wal_bytes()
    e.close()
    assert grown > 2 * 10 * 1100  # lots of dead records
    e2 = NativeEngine(path)
    assert e2.wal_bytes() < grown / 10  # compacted on open
    assert len(e2) == 10
    for k in range(10):
        assert e2.get(f"key{k}".encode()) == bytes([299 % 256]) * 1024
    e2.close()


def test_python_wal_compaction_and_fsync(tmp_path):
    """The port's Python engine has the same compaction and fsync options."""
    path = str(tmp_path / "db")
    e = WalEngine(path, fsync_mode=1)
    for round_ in range(300):
        for k in range(10):
            e.put(f"key{k}".encode(), bytes([round_ % 256]) * 1024)
    e.close()
    grown = os.path.getsize(os.path.join(path, "wal.log"))
    e2 = WalEngine(path)
    compacted = os.path.getsize(os.path.join(path, "wal.log"))
    assert compacted < grown / 10
    assert len(e2) == 10
    e2.close()


def test_store_actor_uses_native_engine(tmp_path, monkeypatch):
    """``open_engine`` and ``Store`` open the C++ engine by default; the
    Python one on request or with ``HOTSTUFF_STORE_NATIVE=0``."""
    e = open_engine(str(tmp_path / "db"))
    assert type(e) is NativeEngine
    e.close()
    store = Store(str(tmp_path / "db2"))
    assert type(store.engine) is NativeEngine
    store.close()
    assert type(open_engine(str(tmp_path / "db3"), prefer_native=False)) is WalEngine
    monkeypatch.setenv("HOTSTUFF_STORE_NATIVE", "0")
    assert type(open_engine(str(tmp_path / "db4"))) is WalEngine


def test_a_missing_parent_directory_is_made(tmp_path):
    """The store's parent directories are made, as ``WalEngine`` makes
    them (the JAX C++ engine fails there and its ``open_engine`` falls
    back to the Python engine: either way the store opens)."""
    for i, opener in enumerate((NativeEngine, WalEngine)):
        path = str(tmp_path / f"missing{i}" / "parent" / "db")
        e = opener(path)
        e.put(b"k", b"v")
        e.close()
        assert opener(path).get(b"k") == b"v"


# ---- files across packages and engines ---------------------------------------


@pytest.mark.parametrize(
    "writer,reader",
    [("jax-native", "port-native"), ("jax-native", "port-wal"),
     ("port-native", "jax-native"), ("port-native", "jax-wal")],
)
def test_a_wal_written_by_one_package_opens_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    w = ENGINES[writer](path)
    for i in range(40):
        w.put(b"key%d" % i, b"%s value %d" % (writer.encode(), i))
    w.delete(b"key7")
    w.put(b"key3", b"overwritten")
    w.close()
    r = ENGINES[reader](path)
    assert len(r) == 39 and r.get(b"key7") is None
    assert r.get(b"key3") == b"overwritten"
    assert r.get(b"key39") == b"%s value 39" % writer.encode()
    assert sorted(r.keys()) == sorted(b"key%d" % i for i in range(40) if i != 7)
    r.put(b"from-reader", reader.encode())
    r.close()
    again = ENGINES[writer](path)
    assert again.get(b"from-reader") == reader.encode() and len(again) == 40
    again.close()


def _ops(seed: int, n: int, keys: int):
    """A seeded put/delete sequence over ``keys`` keys (values of 0-600
    random bytes, about one op in six a delete)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        key = b"k/%d" % int(rng.integers(0, keys))
        if rng.random() < 1 / 6:
            ops.append((key, None))
        else:
            ops.append((key, rng.bytes(int(rng.integers(0, 601)))))
    return ops


@pytest.mark.parametrize("seed,n,keys", [(1, 400, 50), (2, 8000, 8)], ids=["spread", "overwrites"])
def test_the_same_sequence_gives_byte_equal_files_in_every_engine(tmp_path, seed, n, keys):
    """Byte-equal WALs after the sequence in all four engines.  After a
    reopen (the ``overwrites`` sequence leaves enough dead records to
    compact) each package's engine equals the other package's engine of
    its kind: the C++ and the Python compaction write the live records in
    their own index orders."""
    ops = _ops(seed, n, keys)
    files = {}
    for name, engine in ENGINES.items():
        path = str(tmp_path / name)
        e = engine(path)
        for key, value in ops:
            if value is None:
                e.delete(key)
            else:
                e.put(key, value)
        e.close()
        first = Path(path, "wal.log").read_bytes()
        engine(path).close()
        files[name] = (first, Path(path, "wal.log").read_bytes())
    assert len({f for f, _ in files.values()}) == 1
    assert files["port-native"][1] == files["jax-native"][1]
    assert files["port-wal"][1] == files["jax-wal"][1]
    contents = []
    for name, engine in ENGINES.items():
        e = engine(str(tmp_path / name))
        contents.append({k: e.get(k) for k in e.keys()})
        e.close()
    assert all(c == contents[0] for c in contents)
    if keys == 8:
        assert len(files["port-native"][1]) < len(files["port-native"][0]) / 10


# ---- a library that cannot build -----------------------------------------------


@pytest.mark.parametrize("fault", ["no compiler", "broken source"])
def test_a_store_library_that_cannot_build_raises(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(_native_build, "_LIBS", {})
    monkeypatch.delenv("HOTSTUFF_STORE_NATIVE", raising=False)
    if fault == "no compiler":
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        match = "cannot build libhs_store"
    else:
        copy = tmp_path / "native"
        copy.mkdir()
        source = (ROOT / "native" / "store_engine.cpp").read_text()
        (copy / "store_engine.cpp").write_text(source + "\nthis is not C++;\n")
        monkeypatch.setattr(_native_build, "NATIVE_DIR", copy)
        match = "failed \\(1\\) building libhs_store:(.|\\n)*error"
    with pytest.raises(RuntimeError, match=match):
        open_engine(str(tmp_path / "db"))
    with pytest.raises(RuntimeError, match=match):
        Store(str(tmp_path / "db"))
    assert not (tmp_path / "db").exists()
    e = open_engine(str(tmp_path / "db"), prefer_native=False)
    assert type(e) is WalEngine
    e.close()
