"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2).

A copy of ``hotstuff_tpu.crypto.bls.curve``, whole: the same wire bytes
(``to_bytes`` / ``from_bytes``) and the arbitrary-precision oracle of
the port's G1 kernels (``hotstuff_tpu_torch/gpu/bls.py``).

G1: y^2 = x^3 + 4         over Fq,  order R, cofactor H1.
G2: y^2 = x^3 + 4(u + 1)  over Fq2, order R, cofactor H2.

The public API is affine (points compare and serialize by affine
coordinates, matching the wire formats), but all scalar multiplication
and multi-point accumulation run in Jacobian coordinates internally —
one field inversion per *operation* instead of one per *point addition*
(the round-1 affine ladder cost ~500 modular inversions per scalar
multiply, ~700 ms; Jacobian is ~1-3 ms).  The same generic ladder
serves both fields: the coordinate ops are passed in as closures.

Round-1 bug fixed here: ``mul`` reduces its scalar mod R, so the
serialization subgroup check ``pt.mul(R)`` was a no-op (mul(0) — every
on-curve point passed).  Subgroup and cofactor multiplications now use
the unreduced ``_mul_raw``, and the check is pinned by a test with an
on-curve point outside the r-torsion (tests/test_bls.py).
"""

from __future__ import annotations

import hashlib

from .fields import P, R, Fq2, fq_inv

H1 = 0x396C8C005555E1568C00AAAB0000AAAB
H2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

# Standard generators (RFC 9380 / zkcrypto test vectors).
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


# -- generic Jacobian ladder -------------------------------------------------
#
# A point is (X, Y, Z); Z "zero" means the identity.  The element ops are
# injected per field: (mul, sqr, red, inv, is_zero, one, zero).


class _Ops:
    __slots__ = ("mul", "sqr", "red", "inv", "is_zero", "one")

    def __init__(self, mul, sqr, red, inv, is_zero, one):
        self.mul, self.sqr, self.red = mul, sqr, red
        self.inv, self.is_zero, self.one = inv, is_zero, one


_FQ_OPS = _Ops(
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    red=lambda a: a % P,
    inv=fq_inv,
    is_zero=lambda a: a % P == 0,
    one=1,
)

_FQ2_OPS = _Ops(
    mul=lambda a, b: a * b,
    sqr=lambda a: a.square(),
    red=lambda a: a,
    inv=lambda a: a.inverse(),
    is_zero=lambda a: a.is_zero(),
    one=Fq2.ONE,
)


def _jac_double(pt, o: _Ops):
    X1, Y1, Z1 = pt
    if o.is_zero(Z1) or o.is_zero(Y1):
        return pt if o.is_zero(Z1) else (X1, Y1, Z1 - Z1)  # 2-torsion → ∞
    A = o.sqr(X1)
    B = o.sqr(Y1)
    C = o.sqr(B)
    t = o.sqr(X1 + B) - A - C
    D = o.red(t + t)
    E = o.red(A + A + A)
    F = o.sqr(E)
    X3 = o.red(F - D - D)
    Y3 = o.red(o.mul(E, D - X3) - (C + C + C + C + C + C + C + C))
    Z3 = o.mul(Y1 + Y1, Z1)
    return (X3, Y3, Z3)


def _jac_add(p1, p2, o: _Ops):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if o.is_zero(Z1):
        return p2
    if o.is_zero(Z2):
        return p1
    Z1Z1 = o.sqr(Z1)
    Z2Z2 = o.sqr(Z2)
    U1 = o.mul(X1, Z2Z2)
    U2 = o.mul(X2, Z1Z1)
    S1 = o.mul(o.mul(Y1, Z2), Z2Z2)
    S2 = o.mul(o.mul(Y2, Z1), Z1Z1)
    H = o.red(U2 - U1)
    rr = o.red(S2 - S1)
    if o.is_zero(H):
        if o.is_zero(rr):
            return _jac_double(p1, o)
        return (o.one, o.one, U1 - U1)  # P + (−P) = ∞ (zero Z)
    I = o.sqr(H + H)
    J = o.mul(H, I)
    rr = rr + rr
    V = o.mul(U1, I)
    X3 = o.red(o.sqr(rr) - J - V - V)
    S1J = o.mul(S1, J)
    Y3 = o.red(o.mul(rr, V - X3) - S1J - S1J)
    Z3 = o.mul(o.red(o.sqr(Z1 + Z2) - Z1Z1 - Z2Z2), H)
    return (X3, Y3, Z3)


def _jac_mul(affine_xy, k: int, o: _Ops):
    """k·P for affine P, k >= 0 unreduced; returns a Jacobian triple."""
    x, y = affine_xy
    inf = (o.one, o.one, x - x)  # zero Z
    if k == 0:
        return inf
    base = (x, y, o.one)
    acc = inf
    for bit in bin(k)[2:]:
        acc = _jac_double(acc, o)
        if bit == "1":
            acc = _jac_add(acc, base, o)
    return acc


def _jac_sum(points_affine, o: _Ops):
    """Σ points (affine list) as a Jacobian triple — one tree-free
    left-fold; each step is a full Jacobian add (no inversions)."""
    if not points_affine:
        return (o.one, o.one, o.one - o.one)
    acc = (points_affine[0][0], points_affine[0][1], o.one)
    for x, y in points_affine[1:]:
        acc = _jac_add(acc, (x, y, o.one), o)
    return acc


def _jac_to_affine(pt, o: _Ops):
    """(x, y) or None for the identity."""
    X, Y, Z = pt
    if o.is_zero(Z):
        return None
    zi = o.inv(o.red(Z))
    zi2 = o.sqr(zi)
    return (o.mul(X, zi2), o.mul(o.mul(Y, zi), zi2))


class G1Point:
    """Affine G1 point; ``inf`` = identity."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x: int = 0, y: int = 0, inf: bool = False):
        self.x = x % P
        self.y = y % P
        self.inf = inf

    @classmethod
    def identity(cls) -> "G1Point":
        return cls(0, 0, True)

    @classmethod
    def generator(cls) -> "G1Point":
        return cls(G1_X, G1_Y)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return (self.y * self.y - self.x**3 - 4) % P == 0

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, G1Point):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf == o.inf
        return self.x == o.x and self.y == o.y

    def __hash__(self) -> int:
        return hash((self.x, self.y, self.inf))

    def __neg__(self) -> "G1Point":
        if self.inf:
            return self
        return G1Point(self.x, -self.y)

    def __add__(self, o: "G1Point") -> "G1Point":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y) % P == 0:
                return G1Point.identity()
            lam = (3 * self.x * self.x) * fq_inv(2 * self.y) % P
        else:
            lam = (o.y - self.y) * fq_inv(o.x - self.x) % P
        x3 = (lam * lam - self.x - o.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return G1Point(x3, y3)

    def _from_jac(self, jac) -> "G1Point":
        aff = _jac_to_affine(jac, _FQ_OPS)
        return G1Point.identity() if aff is None else G1Point(aff[0], aff[1])

    def _mul_raw(self, k: int) -> "G1Point":
        """k·P with the scalar taken as-is (cofactor clearing, subgroup
        checks — where reducing mod R would be wrong)."""
        if self.inf or k == 0:
            return G1Point.identity()
        return self._from_jac(_jac_mul((self.x, self.y), k, _FQ_OPS))

    def mul(self, k: int) -> "G1Point":
        return self._mul_raw(k % R)

    def mul_by_cofactor(self) -> "G1Point":
        return self._mul_raw(H1)

    def in_subgroup(self) -> bool:
        return self._mul_raw(R).inf

    @classmethod
    def sum(cls, points: list["G1Point"]) -> "G1Point":
        """Σ points without per-addition inversions (aggregation path)."""
        affs = [(q.x, q.y) for q in points if not q.inf]
        if not affs:
            return cls.identity()
        aff = _jac_to_affine(_jac_sum(affs, _FQ_OPS), _FQ_OPS)
        return cls.identity() if aff is None else cls(aff[0], aff[1])

    # -- serialization (zcash/ietf compressed format, 48 bytes) -------------

    def to_bytes(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 47)
        flag = 0x80 | (0x20 if self.y > (P - 1) // 2 else 0)
        out = bytearray(self.x.to_bytes(48, "big"))
        out[0] |= flag
        return bytes(out)

    @classmethod
    def from_bytes(
        cls, data: bytes, subgroup_check: bool = True
    ) -> "G1Point | None":
        """``subgroup_check=False`` skips the r-torsion ladder (~2 ms) —
        ONLY for points whose membership is established elsewhere, e.g.
        vote signatures that are summed and checked once per aggregate
        (``BlsVerifier.verify_shared_msg``)."""
        if len(data) != 48 or not data[0] & 0x80:
            return None
        if data[0] & 0x40:  # infinity
            if data[0] != 0xC0 or any(data[1:]):
                return None
            return cls.identity()
        sign = bool(data[0] & 0x20)
        x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
        if x >= P:
            return None
        y2 = (x**3 + 4) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            return None
        if (y > (P - 1) // 2) != sign:
            y = P - y
        pt = cls(x, y)
        if subgroup_check and not pt.in_subgroup():
            return None
        return pt


class G2Point:
    """Affine G2 point over Fq2."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x: Fq2 = Fq2.ZERO, y: Fq2 = Fq2.ZERO, inf: bool = False):
        self.x, self.y, self.inf = x, y, inf

    @classmethod
    def identity(cls) -> "G2Point":
        return cls(Fq2.ZERO, Fq2.ZERO, True)

    @classmethod
    def generator(cls) -> "G2Point":
        return cls(Fq2(*G2_X), Fq2(*G2_Y))

    B2 = None  # set below: 4(u+1)

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        return self.y.square() == self.x.square() * self.x + G2Point.B2

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, G2Point):
            return NotImplemented
        if self.inf or o.inf:
            return self.inf == o.inf
        return self.x == o.x and self.y == o.y

    def __hash__(self) -> int:
        return hash((self.x, self.y, self.inf))

    def __neg__(self) -> "G2Point":
        if self.inf:
            return self
        return G2Point(self.x, -self.y)

    def __add__(self, o: "G2Point") -> "G2Point":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2Point.identity()
            lam = (self.x.square().mul_int(3)) * (self.y.mul_int(2)).inverse()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inverse()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return G2Point(x3, y3)

    def _from_jac(self, jac) -> "G2Point":
        aff = _jac_to_affine(jac, _FQ2_OPS)
        return G2Point.identity() if aff is None else G2Point(aff[0], aff[1])

    def _mul_raw(self, k: int) -> "G2Point":
        if self.inf or k == 0:
            return G2Point.identity()
        return self._from_jac(_jac_mul((self.x, self.y), k, _FQ2_OPS))

    def mul(self, k: int) -> "G2Point":
        return self._mul_raw(k % R)

    def in_subgroup(self) -> bool:
        return self._mul_raw(R).inf

    @classmethod
    def sum(cls, points: list["G2Point"]) -> "G2Point":
        affs = [(q.x, q.y) for q in points if not q.inf]
        if not affs:
            return cls.identity()
        aff = _jac_to_affine(_jac_sum(affs, _FQ2_OPS), _FQ2_OPS)
        return cls.identity() if aff is None else cls(aff[0], aff[1])

    # -- serialization (compressed, 96 bytes) --------------------------------

    def to_bytes(self) -> bytes:
        if self.inf:
            return bytes([0xC0] + [0] * 95)
        # lexicographic "greater" on (c1, c0)
        great = self.y.c1 > (P - 1) // 2 or (
            self.y.c1 == 0 and self.y.c0 > (P - 1) // 2
        )
        flag = 0x80 | (0x20 if great else 0)
        out = bytearray(
            self.x.c1.to_bytes(48, "big") + self.x.c0.to_bytes(48, "big")
        )
        out[0] |= flag
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "G2Point | None":
        if len(data) != 96 or not data[0] & 0x80:
            return None
        if data[0] & 0x40:
            if data[0] != 0xC0 or any(data[1:]):
                return None
            return cls.identity()
        sign = bool(data[0] & 0x20)
        x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:], "big")
        if x0 >= P or x1 >= P:
            return None
        x = Fq2(x0, x1)
        y2 = x.square() * x + G2Point.B2
        y = y2.sqrt()
        if y is None:
            return None
        great = y.c1 > (P - 1) // 2 or (y.c1 == 0 and y.c0 > (P - 1) // 2)
        if great != sign:
            y = -y
        pt = cls(x, y)
        if not pt.in_subgroup():
            return None
        return pt


G2Point.B2 = Fq2(4, 4)


def hash_to_g1(message: bytes, dst: bytes = b"HOTSTUFF_TPU_BLS_G1") -> G1Point:
    """Hash-and-check map to G1 with cofactor clearing.

    Deliberately NOT RFC 9380 SSWU (this backend has no external interop
    requirement); deterministic try-and-increment over SHA-256 counters,
    which is uniform enough for the signature scheme's security argument
    as long as all parties use the same map — they do, it ships with the
    framework.
    """
    counter = 0
    while True:
        h = hashlib.sha256(dst + counter.to_bytes(4, "big") + message).digest()
        x = int.from_bytes(h + hashlib.sha256(b"x2" + h).digest()[:16], "big") % P
        y2 = (x**3 + 4) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P == y2:
            # pick the "even" root deterministically, then clear cofactor
            if y > (P - 1) // 2:
                y = P - y
            return G1Point(x, y).mul_by_cofactor()
        counter += 1
