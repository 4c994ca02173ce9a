"""ctypes bindings of the native batched Ed25519 verifier and wave packer.

A copy of ``hotstuff_tpu.crypto.native_ed25519``, in two halves.

The batch equation (``native/ed25519_batch.cpp``, the port's
``libhs_ed25519`` build): the dalek-parity CPU batch path.  The
reference's ``Signature::verify_batch`` (crypto/src/lib.rs:213-226)
delegates to ed25519-dalek's random-linear-combination batch
verification; the library implements the same equation in C++ (Straus
or Pippenger multiscalar over the 51-bit-limb field).  It is the fast
path for QC-shaped verification (``CpuVerifier.verify_shared_msg``), the
wave service's CPU route, and the CPU baseline
``python -m hotstuff_tpu_torch.bench.verifier`` holds the verify kernel
against.  The ctypes call releases the GIL for the whole batch.

Failure semantics: the batch equation is all-or-nothing; callers that
need per-item attribution fall back to the per-signature loop on a
False.  Acceptance is cofactored (dalek-batch parity); singles stay on
OpenSSL's cofactorless path and the device kernel is cofactorless too,
the same mix the reference ships.  ``HOTSTUFF_ED25519_NATIVE=0`` turns
the batch path off (every CPU verify takes the per-signature loop); with
it on (the default) a library that cannot build raises, with the
compiler's output, where the JAX package logs and falls back.

The wave packer (``native/wave_pack.cpp``): votes parsed at the
reactor's read path land in bucket-shaped staging arenas that the async
verify service adopts as ``frombuffer`` views instead of flattening
Python claim tuples, and batched producer frames parse into a digest
column and body windows.  The ``wp_*`` ABI ships in the port's
transport library, the same ``dlopen`` handle as the reactor's ``ht_*``
surface.  Both libraries are built by ``hotstuff_tpu_torch/_native_build.py``.
"""

from __future__ import annotations

import ctypes
import os

from .. import _native_build

# Where the batch equation beats the per-signature OpenSSL loop, measured
# for the JAX package (n=2: 0.13 vs 0.24 ms; n=256: 8.5 vs 31.4).  n=1
# stays on OpenSSL: a lone signature gets the cofactorless semantics the
# reference uses for singles.  The verifier backend and the async router
# both read it.
NATIVE_BATCH_MIN = 2


def _ed_lib() -> ctypes.CDLL:
    return _native_build.load("ed25519")


def available() -> bool:
    """False when ``HOTSTUFF_ED25519_NATIVE=0`` turns the batch path off;
    else True once the library is built and loaded.  A build or load
    failure raises with the compiler's output instead of answering
    False, so nothing falls back quietly."""
    if os.environ.get("HOTSTUFF_ED25519_NATIVE") == "0":
        return False
    _ed_lib()
    return True


def batch_verify(
    msgs: bytes, msg_len: int, pks: bytes, sigs: bytes, n: int, shared: bool
) -> bool:
    """True iff ALL n signatures satisfy the batch equation.

    ``msgs`` is n*msg_len contiguous bytes (or msg_len bytes when
    ``shared``); ``pks`` n*32; ``sigs`` n*64.  Malformed encodings
    (non-canonical points or scalars) verify False."""
    if n == 0:
        return True
    # lengths are checked before the C call: a short component (a
    # 48-byte BLS-sized signature in an ed25519 batch) is an invalid
    # signature, never an out-of-bounds read
    if (
        len(msgs) != (msg_len if shared else n * msg_len)
        or len(pks) != n * 32
        or len(sigs) != n * 64
    ):
        return False
    return (
        _ed_lib().hs_ed25519_batch_verify(
            msgs, msg_len, pks, sigs, n, 1 if shared else 0
        )
        == 1
    )


def precompute(pubkeys: list[bytes]) -> int:
    """Build the native committee-key tables (epoch setup): each 32-byte
    key gets its decompressed negated point and Straus window table
    cached in the library, so every later small batch only pays point
    work for the per-signature R points.  Returns the number of keys
    cached (wrong-size or off-curve keys are skipped — they fail at
    verify time); 0 when the batch path is off."""
    if not available():
        return 0
    pks = b"".join(pk for pk in pubkeys if len(pk) == 32)
    n = len(pks) // 32
    if n == 0:
        return 0
    return int(_ed_lib().hs_ed25519_precompute(pks, n))


def verify_one(msg: bytes, pk: bytes, sig: bytes) -> bool:
    """Single-signature verify through ``hs_ed25519_verify_one``, with
    cofactored acceptance (the batch equation's).  Callers that need
    the cofactorless single-signature path keep OpenSSL; this is the
    fallback when ``cryptography`` is absent and the alternative is the
    pure-Python ladder."""
    if len(pk) != 32 or len(sig) != 64 or not available():
        return False
    return int(_ed_lib().hs_ed25519_verify_one(msg, len(msg), pk, sig)) == 1


def batch_verify_shared(msg: bytes, votes) -> bool:
    """All (pk_bytes, sig_bytes) pairs over one message (QC shape)."""
    n = len(votes)
    if n == 0:
        return True
    pks = b"".join(pk for pk, _ in votes)
    sigs = b"".join(sig for _, sig in votes)
    return batch_verify(msg, len(msg), pks, sigs, n, shared=True)


def batch_verify_columns(
    dig_addr: int, pks_addr: int, sigs_addr: int, n: int
) -> bool:
    """Batch verify straight from native arena column addresses (the
    ``wave_pack.cpp`` staging memory): no ``b"".join`` flatten, no bytes
    materialized.  The addresses come from ``WavePacker.arena_info`` and
    stay valid until the arena is recycled; the caller owns that
    lifetime."""
    if n == 0:
        return True
    return (
        _ed_lib().hs_ed25519_batch_verify(
            ctypes.cast(dig_addr, ctypes.c_char_p),
            32,
            ctypes.cast(pks_addr, ctypes.c_char_p),
            ctypes.cast(sigs_addr, ctypes.c_char_p),
            n,
            0,
        )
        == 1
    )


# ---------------------------------------------------------------------------
# Wave-pack arena bindings (native/wave_pack.cpp, in the transport library)
# ---------------------------------------------------------------------------

MAX_PRODUCER_BATCH = 512


def _lib() -> ctypes.CDLL:
    return _native_build.load("transport")


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
    "NATIVE_BATCH_MIN",
    "available",
    "batch_verify",
    "batch_verify_columns",
    "batch_verify_shared",
    "precompute",
    "verify_one",
    "WavePacker",
    "column_view",
    "parse_producer",
    "probe_vote",
    "wave_pack_available",
]
