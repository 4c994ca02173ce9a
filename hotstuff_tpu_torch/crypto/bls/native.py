"""ctypes bridge to the native C++ BLS12-381 verifier (native/bls_pairing.cpp).

A copy of ``hotstuff_tpu.crypto.bls.native``.  The C++ side is a direct
port of this package's field/curve/pairing code (same tower, same
Miller-loop structure, same framework-internal hash-to-G1), so a
signature valid under one is valid under the other.  The library is the
port's own build (``hotstuff_tpu_torch/_native_build.py``, ``bls``:
``-O3`` as ``native/Makefile``'s rule, into ``build/torch_native/``),
made on first use, never at import.

It carries the per-message pairings (a timeout flood's distinct digests)
and the point aggregation of the host route; the per-certificate
aggregate checks are one pairing equality on either route.

``HOTSTUFF_BLS_NATIVE=0`` forces the Python pairing, as in the JAX
package.  Otherwise the library runs its bilinearity selftest once, at
first use, and a failed build, load or selftest raises: the JAX package
falls back to the Python pairing quietly, the port names the switch
instead.
"""

from __future__ import annotations

import ctypes
import os
import secrets
import threading

from ... import _native_build

_LIB_NAME = "libhs_bls"
_lock = threading.Lock()
_checked: ctypes.CDLL | None = None


def enabled() -> bool:
    """False when ``HOTSTUFF_BLS_NATIVE=0`` selects the Python pairing."""
    return os.environ.get("HOTSTUFF_BLS_NATIVE") != "0"


def _lib() -> ctypes.CDLL:
    """The library, built and selftested on first use; raises on any
    failure."""
    global _checked
    with _lock:
        if _checked is None:
            lib = _native_build.load("bls")
            if lib.hs_bls_selftest() != 1:
                raise RuntimeError(
                    f"{_LIB_NAME} failed its bilinearity selftest; set "
                    "HOTSTUFF_BLS_NATIVE=0 to use the Python pairing"
                )
            _checked = lib
        return _checked


def available() -> bool:
    """False with ``HOTSTUFF_BLS_NATIVE=0``; else True once the library
    is built, loaded and selftested (a failure raises)."""
    if not enabled():
        return False
    _lib()
    return True


def verify_one(
    message: bytes, pk96: bytes, sig48: bytes, check_pk_subgroup: bool = True
) -> bool:
    """Native verification: e(sig, G2) == e(H(msg), pk), with on-curve
    AND subgroup checks (matching the Python path).
    ``check_pk_subgroup=False`` skips the pk r-torsion ladder — ONLY for
    keys whose membership is already established (an aggregate of
    individually checked committee keys)."""
    if len(pk96) != 96 or len(sig48) != 48:
        return False
    return bool(
        _lib().hs_bls_verify_one_ex(
            message, len(message), pk96, sig48, 1 if check_pk_subgroup else 0
        )
    )


def aggregate_sigs(sigs48: list[bytes]) -> bytes | None:
    """Sum compressed G1 signatures natively (on-curve checked; the
    aggregate's subgroup membership is checked by verify_one).  None on
    malformed input."""
    if any(len(s) != 48 for s in sigs48):
        return None
    buf = b"".join(sigs48)
    out = ctypes.create_string_buffer(48)
    if not _lib().hs_bls_aggregate_sigs(buf, len(sigs48), out):
        return None
    return out.raw


def verify_batch(
    digests32: list[bytes],
    pks96: list[bytes],
    sigs48: list[bytes],
    check_pk_subgroup: bool = True,
) -> bool:
    """Random-weight batched verification over DISTINCT 32-byte digests
    (the TC shape): n+1 Miller loops sharing one final exponentiation.
    True = every entry valid; False = at least one invalid (re-check per
    item to pinpoint).  Weights are generated here — their secrecy /
    unpredictability is what makes cross-entry cancellation infeasible."""
    n = len(digests32)
    if n == 0 or len(pks96) != n or len(sigs48) != n:
        return False  # a short list would read past the joined buffers
    if any(len(d) != 32 for d in digests32):
        return False
    if any(len(p) != 96 for p in pks96) or any(len(s) != 48 for s in sigs48):
        return False
    weights = b"".join(
        (secrets.randbits(128) | 1).to_bytes(16, "little") for _ in range(n)
    )
    return bool(
        _lib().hs_bls_verify_batch(
            b"".join(digests32),
            b"".join(pks96),
            b"".join(sigs48),
            n,
            weights,
            1 if check_pk_subgroup else 0,
        )
    )


# ---- device-offload split ---------------------------------------------------
# The per-entry G1 ladders of the distinct-digest batch run on the card
# (gpu/bls.py StormOffload); these are the host ends.


def g1_decompress_many(sigs48: list[bytes]) -> bytes | None:
    """Compressed signatures -> uncompressed affine (96 B each,
    on-curve checked; subgroup membership is the device ladder's job).
    None on malformed input."""
    n = len(sigs48)
    if n == 0 or any(len(s) != 48 for s in sigs48):
        return None
    out = ctypes.create_string_buffer(96 * n)
    if not _lib().hs_bls_g1_decompress_many(b"".join(sigs48), n, out):
        return None
    return out.raw


def hash_base_many(digests32: list[bytes]) -> bytes | None:
    """Digests -> PRE-cofactor hash base points, uncompressed affine."""
    n = len(digests32)
    if n == 0 or any(len(d) != 32 for d in digests32):
        return None
    out = ctypes.create_string_buffer(96 * n)
    if not _lib().hs_bls_hash_base_many(b"".join(digests32), n, out):
        return None
    return out.raw


def verify_batch_points(
    whm96: bytes, pks96: list[bytes], agg96: bytes,
    check_pk_subgroup: bool = True,
) -> bool:
    """Pairing product over device-computed points: whm96 = n contiguous
    uncompressed (r_i * h_eff) * H_base(m_i); agg96 = sum r_i * sig_i."""
    n = len(pks96)
    if n == 0 or len(whm96) != 96 * n or len(agg96) != 96:
        return False
    if any(len(p) != 96 for p in pks96):
        return False
    return bool(
        _lib().hs_bls_verify_batch_points(
            whm96, b"".join(pks96), n, agg96, 1 if check_pk_subgroup else 0
        )
    )
