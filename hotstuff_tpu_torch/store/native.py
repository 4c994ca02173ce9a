"""ctypes bridge to the native C++ WAL engine (native/store_engine.cpp).

A copy of ``hotstuff_tpu.store.native`` over the port's own build of the
library (``libhs_store_<hash>.so``, ``hotstuff_tpu_torch/_native_build.py``).
Same on-disk WAL format as the pure-Python ``WalEngine``
(``store/engine.py``): either engine, of either package, recovers the
other's files.  A library that cannot build raises with the compiler's
output; ``open_engine(..., prefer_native=False)`` or
``HOTSTUFF_STORE_NATIVE=0`` opens the Python engine instead.

Durability: ``fsync_mode`` 0 = flush per put (process-crash safe),
1 = fdatasync per put (power-loss safe), 2 = fdatasync on close.

Added to the copy: ``batch()``, a block inside which puts and deletes
are held and then appended with one write (the port's ``hs_put_many``,
``store/csrc/store_batch.cpp``): the same log bytes as the same calls
one by one, one system call in place of one a record, and the block's
records land together or, if the process dies inside it, not at all
(``fsync_mode`` 1 syncs once, at its end).  ``StateMachine.apply_block``
applies a committed block inside one.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import struct
from typing import Iterator

from .. import _native_build

_U32 = struct.Struct("<I")
_HDR = struct.Struct("<II")  # a WAL record's klen, vlen
_TOMBSTONE = 0xFFFFFFFF
_DELETED = object()  # a batch's delete, as its overlay holds it


class NativeEngine:
    """Engine-protocol adapter over the C++ WAL engine."""

    def __init__(self, path: str, fsync_mode: int = 0):
        self._lib = _native_build.load("store")
        # hs_open makes the store's own directory but not its parents;
        # make them as WalEngine does (the JAX engine fails here, and its
        # open_engine then opens WalEngine instead)
        os.makedirs(path, exist_ok=True)
        self._h = self._lib.hs_open(path.encode(), fsync_mode)
        if not self._h:
            raise OSError(f"hs_open failed for {path!r}")
        self.path = path
        # inside batch(): the held records, and the keys they set
        self._records: list[bytes] | None = None
        self._overlay: dict = {}

    @contextlib.contextmanager
    def batch(self):
        """Hold every put and delete of the block, reads seeing them, and
        append them with one call when it ends (also when it raises, so
        the calls made stay made, as one by one).  Not reentrant."""
        if self._records is not None:
            raise RuntimeError("NativeEngine.batch is not reentrant")
        self._records = []
        try:
            yield self
        finally:
            self._write_held()

    def _write_held(self) -> None:
        records, self._records = self._records, None
        self._overlay = {}
        if records:
            blob = b"".join(records)
            if self._lib.hs_put_many(self._h, blob, len(blob)) != 0:
                raise OSError("hs_put_many failed")

    def put(self, key: bytes, value: bytes) -> None:
        if self._records is not None:
            self._records.append(_HDR.pack(len(key), len(value)) + key + value)
            self._overlay[key] = value
            return
        if self._lib.hs_put(self._h, key, len(key), value, len(value)) != 0:
            raise OSError("hs_put failed")

    def get(self, key: bytes) -> bytes | None:
        if self._overlay:
            held = self._overlay.get(key)
            if held is not None:
                return None if held is _DELETED else held
        out = ctypes.POINTER(ctypes.c_uint8)()
        outlen = ctypes.c_uint32()
        rc = self._lib.hs_get(
            self._h, key, len(key), ctypes.byref(out), ctypes.byref(outlen)
        )
        if rc == -1:
            return None
        if rc != 0:
            raise OSError("hs_get failed")
        try:
            return ctypes.string_at(out, outlen.value)
        finally:
            self._lib.hs_free(out)

    def delete(self, key: bytes) -> None:
        if self._records is not None:
            self._records.append(_HDR.pack(len(key), _TOMBSTONE) + key)
            self._overlay[key] = _DELETED
            return
        if self._lib.hs_delete(self._h, key, len(key)) != 0:
            raise OSError("hs_delete failed")

    def keys(self) -> Iterator[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        outlen = ctypes.c_uint64()
        if self._lib.hs_keys_blob(self._h, ctypes.byref(out), ctypes.byref(outlen)):
            raise OSError("hs_keys_blob failed")
        try:
            blob = ctypes.string_at(out, outlen.value)
        finally:
            self._lib.hs_free(out)
        (count,) = _U32.unpack_from(blob, 0)
        off = 4
        result = []
        for _ in range(count):
            (klen,) = _U32.unpack_from(blob, off)
            off += 4
            result.append(blob[off : off + klen])
            off += klen
        return iter(result)

    def __len__(self) -> int:
        return int(self._lib.hs_count(self._h))

    def wal_bytes(self) -> int:
        return int(self._lib.hs_wal_bytes(self._h))

    def compact(self) -> None:
        if self._lib.hs_compact(self._h) != 0:
            raise OSError("hs_compact failed")

    def close(self) -> None:
        if self._h:
            self._lib.hs_close(self._h)
            self._h = None
