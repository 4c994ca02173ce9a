"""ctypes bindings of the native wave packer (``native/wave_pack.cpp``).

A copy of the wave-pack half of ``hotstuff_tpu.crypto.native_ed25519``:
votes parsed at the reactor's read path land in bucket-shaped staging
arenas that the async verify service adopts as ``frombuffer`` views
instead of flattening Python claim tuples, and batched producer frames
parse into a digest column and body windows.  The ``wp_*`` ABI ships in
the port's transport library (``network/_native_build.py``), the same
``dlopen`` handle as the reactor's ``ht_*`` surface.

The batch-equation half of the JAX module (``libhs_ed25519.so``, the
native CPU verify route) is not ported.
"""

from __future__ import annotations

import ctypes

MAX_PRODUCER_BATCH = 512


def _lib() -> ctypes.CDLL:
    from ..network import _native_build

    return _native_build.load()


def wave_pack_available() -> bool:
    """True once the library is built and loaded; a build or load
    failure raises with the compiler's output instead of answering
    False, so nothing falls back quietly."""
    _lib()
    return True


def probe_vote(frame: bytes) -> bool:
    """Stateless Decoder-parity accept/reject for a vote frame (the
    differential fuzz drives this against the Python decoder)."""
    return _lib().wp_probe_vote(frame, len(frame)) == 1


def parse_producer(frame: bytes):
    """Decoder-parity producer-v2 parse: ``(digests, spans)`` where
    ``digests`` is the packed 32-byte digest column and ``spans`` a list
    of ``(offset, length)`` body windows into ``frame``; None for any
    frame the Python decoder rejects."""
    digs = ctypes.create_string_buffer(MAX_PRODUCER_BATCH * 32)
    spans = (ctypes.c_uint64 * (MAX_PRODUCER_BATCH * 2))()
    n = _lib().wp_parse_producer(frame, len(frame), digs, spans)
    if n < 0:
        return None
    return (
        digs.raw[: n * 32],
        [(spans[2 * i], spans[2 * i + 1]) for i in range(n)],
    )


class WavePacker:
    """Owner of one native arena ring.  ``pack_vote`` runs on the event
    loop (the receive path); ``recycle`` runs on verifier slot threads
    once the adopted views are consumed — the native side serializes
    both under one mutex."""

    def __init__(self, capacity: int, ring_depth: int = 4):
        self._lib = _lib()
        self._h = self._lib.wp_create(capacity, ring_depth)
        if not self._h:
            raise MemoryError("wp_create failed")
        self.capacity = capacity
        self.ring_depth = ring_depth
        self._digest_out = ctypes.create_string_buffer(32)

    def close(self) -> None:
        if self._h:
            self._lib.wp_destroy(self._h)
            self._h = None

    def set_pad(self, digest: bytes, pk: bytes, sig: bytes) -> bool:
        return self._lib.wp_set_pad(self._h, digest, pk, sig) == 0

    def pack_vote(self, frame: bytes):
        """``(row_slot, claim_digest32)`` on success, else the negative
        native error code (int): -1 malformed frame, -2 open arena
        full, -3 no pad installed."""
        slot = self._lib.wp_pack_vote(
            self._h, frame, len(frame), self._digest_out
        )
        if slot < 0:
            return int(slot)
        return slot, self._digest_out.raw

    def count(self) -> int:
        return int(self._lib.wp_count(self._h))

    def seal(self, n_take: int) -> int | None:
        """Seal the open arena at ``n_take`` rows (surplus rows carry
        over to the next arena).  Returns the sealed arena index."""
        idx = self._lib.wp_seal(self._h, n_take)
        return None if idx < 0 else int(idx)

    def arena_info(self, arena: int):
        """``(dig_addr, pk_addr, sig_addr, rows, capacity)`` of a sealed
        arena — feed the addresses to ``column_view``."""
        out = (ctypes.c_uint64 * 5)()
        if self._lib.wp_arena_info(self._h, arena, out) != 0:
            return None
        return tuple(int(x) for x in out)

    def recycle(self, arena: int) -> bool:
        return self._lib.wp_recycle(self._h, arena) == 0

    def discard(self) -> bool:
        return self._lib.wp_discard(self._h) == 0

    def counters(self) -> dict:
        out = (ctypes.c_uint64 * 7)()
        n = self._lib.wp_counters(self._h, out, 7)
        names = (
            "packed", "reject", "full", "seal", "discard", "recycle", "moved",
        )
        return {names[i]: int(out[i]) for i in range(n)}


def column_view(addr: int, nbytes: int):
    """Writable buffer over ``nbytes`` of native arena memory at
    ``addr`` (a buffer-protocol object ``np.frombuffer`` accepts
    directly).  Valid only until the owning arena is recycled."""
    return (ctypes.c_uint8 * nbytes).from_address(addr)


__all__ = [
    "MAX_PRODUCER_BATCH",
    "WavePacker",
    "column_view",
    "parse_producer",
    "probe_vote",
    "wave_pack_available",
]
