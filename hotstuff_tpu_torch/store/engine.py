"""Persistent key-value engine backing the Store.

A copy of ``hotstuff_tpu.store.engine``.  The port ships two engines
behind one interface:

- ``WalEngine`` (this module, pure Python): an in-memory index + an
  append-only write-ahead log, replayed on open.  Crash recovery =
  reopen the same path.
- ``NativeEngine`` (``store/native.py``, ``native/store_engine.cpp`` via
  ctypes): the C++ engine with the same WAL format, the default of
  ``open_engine``.

The on-disk format is the JAX package's byte for byte, so a store
written by either engine of either package opens in the others.

WAL record format (little-endian): u32 klen | u32 vlen | key | value.
A record with vlen == 0xFFFFFFFF is a tombstone (delete).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Protocol

_HDR = struct.Struct("<II")
TOMBSTONE = 0xFFFFFFFF


class Engine(Protocol):
    def put(self, key: bytes, value: bytes) -> None: ...

    def get(self, key: bytes) -> bytes | None: ...

    def delete(self, key: bytes) -> None: ...

    def keys(self) -> Iterator[bytes]: ...

    def close(self) -> None: ...


class WalEngine:
    """Append-only WAL + in-memory hash index.

    ``fsync_mode``: 0 = flush to the OS page cache per put (survives
    process death — the default, matching the benchmark configuration),
    1 = fsync per put (survives OS/power loss), 2 = fsync on close only.
    On open, a log carrying more than ``COMPACT_RATIO`` x its live bytes
    (and at least ``COMPACT_MIN`` bytes) is rewritten to bound disk
    growth across restarts.
    """

    COMPACT_RATIO = 2.0
    COMPACT_MIN = 1 << 20  # 1 MiB

    def __init__(self, path: str, fsync_mode: int = 0):
        self.path = path
        self.fsync_mode = fsync_mode
        os.makedirs(path, exist_ok=True)
        self._wal_path = os.path.join(path, "wal.log")
        self._index: dict[bytes, bytes] = {}
        self._replay()
        self._maybe_compact()
        self._wal = open(self._wal_path, "ab")

    def _replay(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            data = f.read()
        off, n = 0, len(data)
        valid_end = 0  # end offset of the last complete record
        while off + _HDR.size <= n:
            klen, vlen = _HDR.unpack_from(data, off)
            off += _HDR.size
            if vlen == TOMBSTONE:
                if off + klen > n:
                    break  # torn tail record — discard
                key = data[off : off + klen]
                off += klen
                self._index.pop(key, None)
            else:
                if off + klen + vlen > n:
                    break  # torn tail record — discard
                key = data[off : off + klen]
                off += klen
                self._index[key] = data[off : off + vlen]
                off += vlen
            valid_end = off
        if valid_end < n:
            # truncate the torn tail so post-recovery appends don't get
            # stranded behind unparseable garbage on the next replay
            with open(self._wal_path, "r+b") as f:
                f.truncate(valid_end)

    def _maybe_compact(self) -> None:
        try:
            size = os.path.getsize(self._wal_path)
        except OSError:
            return
        live = sum(
            _HDR.size + len(k) + len(v) for k, v in self._index.items()
        )
        if size < self.COMPACT_MIN or size <= self.COMPACT_RATIO * live:
            return
        tmp = self._wal_path + ".compact"
        with open(tmp, "wb") as f:
            for k, v in self._index.items():
                f.write(_HDR.pack(len(k), len(v)))
                f.write(k)
                f.write(v)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal_path)

    def _sync(self) -> None:
        self._wal.flush()
        if self.fsync_mode == 1:
            os.fsync(self._wal.fileno())

    def put(self, key: bytes, value: bytes) -> None:
        self._wal.write(_HDR.pack(len(key), len(value)))
        self._wal.write(key)
        self._wal.write(value)
        self._sync()
        self._index[key] = value

    def get(self, key: bytes) -> bytes | None:
        return self._index.get(key)

    def delete(self, key: bytes) -> None:
        self._wal.write(_HDR.pack(len(key), TOMBSTONE))
        self._wal.write(key)
        self._sync()
        self._index.pop(key, None)

    def keys(self) -> Iterator[bytes]:
        return iter(list(self._index.keys()))

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        if not self._wal.closed:
            self._wal.flush()
            if self.fsync_mode != 0:
                os.fsync(self._wal.fileno())
            self._wal.close()
