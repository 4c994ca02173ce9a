"""Deterministic binary wire codec.

The reference serializes every protocol message with bincode
(reference ``consensus/src/consensus.rs:30-38`` and friends). This is the
framework's equivalent: a tiny, explicit, deterministic little-endian
codec — fixed-width ints, u32-length-prefixed variable bytes, 1-byte
option flags — so the wire format is fully specified here rather than
inherited from a serialization library.

A copy of ``hotstuff_tpu.utils.codec``: the port's messages encode to
the same bytes as the JAX package's.
"""

from __future__ import annotations


class CodecError(Exception):
    """Malformed or truncated wire data."""


class Encoder:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "Encoder":
        self._parts.append(v.to_bytes(1, "little"))
        return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(v.to_bytes(2, "little"))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(v.to_bytes(4, "little"))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(v.to_bytes(8, "little"))
        return self

    def u128(self, v: int) -> "Encoder":
        self._parts.append(v.to_bytes(16, "little"))
        return self

    def raw(self, b: bytes) -> "Encoder":
        """Fixed-size bytes: no length prefix (caller knows the size)."""
        self._parts.append(b)
        return self

    def var_bytes(self, b: bytes) -> "Encoder":
        self.u32(len(b))
        self._parts.append(b)
        return self

    def flag(self, present: bool) -> "Encoder":
        return self.u8(1 if present else 0)

    def finish(self) -> bytes:
        return b"".join(self._parts)


class Decoder:
    # pk_size/sig_size: optional wire-size expectation for key/signature
    # fields, set by the entry point that knows the committee's scheme
    # (wire.decode_message).  None = accept any size the value type
    # allows (trusted/loopback decode paths).  Narrowing this at decode
    # time keeps an ed25519 committee from parsing 96-byte BLS keys off
    # the wire at all (hostile-input surface, ADVICE r2).
    # compact_sig_size/compact_bitmap_max: the same narrowing for the
    # compact (aggregated) certificate form — None = accept (unpinned),
    # a positive size = enforce, 0 = the scheme has no compact form and
    # any compact certificate is a CodecError
    # (wire.SCHEME_COMPACT_SIZES).
    __slots__ = (
        "_data", "_pos", "pk_size", "sig_size",
        "compact_sig_size", "compact_bitmap_max",
    )

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self.pk_size: int | None = None
        self.sig_size: int | None = None
        self.compact_sig_size: int | None = None
        self.compact_bitmap_max: int | None = None

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise CodecError(
                f"truncated: need {n} bytes at offset {self._pos}, "
                f"have {len(self._data) - self._pos}"
            )
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self._take(2), "little")

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def u128(self) -> int:
        return int.from_bytes(self._take(16), "little")

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def var_bytes(self, max_len: int = 1 << 24) -> bytes:
        n = self.u32()
        if n > max_len:
            raise CodecError(f"length {n} exceeds cap {max_len}")
        return self._take(n)

    def flag(self) -> bool:
        v = self.u8()
        if v not in (0, 1):
            raise CodecError(f"invalid option flag {v}")
        return v == 1

    def mark(self) -> int:
        """Current position, for ``since`` wire-slice capture."""
        return self._pos

    def since(self, mark: int) -> bytes:
        """The raw bytes consumed since ``mark`` — lets message decoders
        retain their exact wire encoding so a later serialize() is a
        cached-bytes return instead of a re-encode (the store path
        re-serialized every received block)."""
        return self._data[mark : self._pos]

    def finish(self) -> None:
        """Assert the input was fully consumed."""
        if self._pos != len(self._data):
            raise CodecError(
                f"{len(self._data) - self._pos} trailing bytes after decode"
            )
