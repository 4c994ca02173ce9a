"""BLS12-381 field tower: Fq -> Fq2 -> Fq6 -> Fq12.

A copy of ``hotstuff_tpu.crypto.bls.fields``, whole.

Pure-Python arbitrary-precision arithmetic — the CPU reference backend
for the threshold-signature variant (BASELINE config 5; the reference
exposes the equivalent boundary at crypto/src/lib.rs:232-257).  The TPU
aggregation design builds on G1 point addition only (see
docs/BLS_TPU_DESIGN.md); pairings stay host-side in both designs.

Tower construction (the standard one used by every BLS12-381
implementation):
  Fq2  = Fq[u]  / (u^2 + 1)
  Fq6  = Fq2[v] / (v^3 - (u + 1))
  Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

# Base field prime.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order (scalar field).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative: x = -0xd201000000010000).
X = -0xD201000000010000


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


class Fq2:
    """a + b·u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    ZERO: "Fq2"
    ONE: "Fq2"

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def mul_int(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        # (a + bu)^2 = (a+b)(a-b) + 2ab u
        return Fq2(
            (self.c0 + self.c1) * (self.c0 - self.c1), 2 * self.c0 * self.c1
        )

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inverse(self) -> "Fq2":
        # 1/(a+bu) = (a - bu)/(a^2 + b^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        inv = fq_inv(norm)
        return Fq2(self.c0 * inv, -self.c1 * inv)

    def mul_by_nonresidue(self) -> "Fq2":
        # * (u + 1)
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1
        )

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))

    def __repr__(self) -> str:
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"

    def pow(self, e: int) -> "Fq2":
        result = Fq2.ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 (used by G2 decompression), via the
        Adj-Rodríguez-Henríquez method for p ≡ 3 (mod 4)."""
        if self.is_zero():
            return Fq2.ZERO
        a1 = self.pow((P - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fq2(-1 % P, 0):
            return Fq2(-x0.c1, x0.c0)
        b = (alpha + Fq2.ONE).pow((P - 1) // 2)
        cand = b * x0
        return cand if cand.square() == self else None


Fq2.ZERO = Fq2(0, 0)
Fq2.ONE = Fq2(1, 0)


class Fq6:
    """a + b·v + c·v^2 with v^3 = u + 1."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    ZERO: "Fq6"
    ONE: "Fq6"

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_nonresidue(self) -> "Fq6":
        # * v
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inverse(self) -> "Fq6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_nonresidue()
        t1 = c.square().mul_by_nonresidue() - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1 + b * t2).mul_by_nonresidue()
        inv = denom.inverse()
        return Fq6(t0 * inv, t1 * inv, t2 * inv)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self) -> int:
        return hash((self.c0, self.c1, self.c2))


Fq6.ZERO = Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)
Fq6.ONE = Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)


class Fq12:
    """a + b·w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    ONE: "Fq12"

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c0 = t0 + t1.mul_by_nonresidue()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        # complex squaring: (c0 + c1 w)² = (c0² + v·c1²) + 2c0c1·w with
        # c0² + v·c1² = (c0 + c1)(c0 + v·c1) − t − v·t, t = c0c1
        # — 2 Fq6 multiplies instead of 3.
        t = self.c0 * self.c1
        m = (self.c0 + self.c1) * (self.c0 + self.c1.mul_by_nonresidue())
        return Fq12(m - t - t.mul_by_nonresidue(), t + t)

    def cyclotomic_square(self) -> "Fq12":
        """Granger-Scott squaring — valid ONLY for elements of the
        cyclotomic subgroup (f^(p⁴−p²+1) = 1, i.e. anything after the
        easy part of the final exponentiation).  Fq12 as Fq4[z]/(z³−y)
        with Fq4 components (c0.c0, c1.c1), (c1.c0, c0.c2),
        (c0.c1, c1.c2); ~3x cheaper than ``square`` — the exponentiation
        chain of the hard part runs almost entirely on this.
        Pinned against ``square`` on cyclotomic elements in tests."""
        z0, z4, z3 = self.c0.c0, self.c0.c1, self.c0.c2
        z2, z1, z5 = self.c1.c0, self.c1.c1, self.c1.c2

        def fq4_square(a0: Fq2, a1: Fq2) -> tuple[Fq2, Fq2]:
            # (a0 + a1 y)² with y² = u+1
            t = a0 * a1
            sq = (a0 + a1) * (a0 + a1.mul_by_nonresidue())
            return sq - t - t.mul_by_nonresidue(), t + t

        t0, t1 = fq4_square(z0, z1)
        t2, t3 = fq4_square(z2, z3)
        t4, t5 = fq4_square(z4, z5)
        # z_i' = 3·t − (±)2·z with the Granger-Scott sign pattern
        z0 = t0 + (t0 - z0) + (t0 - z0)
        z1 = t1 + (t1 + z1) + (t1 + z1)
        nr_t5 = t5.mul_by_nonresidue()
        z2 = nr_t5 + (nr_t5 + z2) + (nr_t5 + z2)
        z3 = t4 + (t4 - z3) + (t4 - z3)
        z4 = t2 + (t2 - z4) + (t2 - z4)
        z5 = t3 + (t3 + z5) + (t3 + z5)
        return Fq12(Fq6(z0, z4, z3), Fq6(z2, z1, z5))

    def conjugate(self) -> "Fq12":
        return Fq12(self.c0, -self.c1)

    def inverse(self) -> "Fq12":
        denom = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_nonresidue()).inverse()
        return Fq12(self.c0 * denom, -(self.c1 * denom))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inverse().pow(-e)
        result = Fq12.ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self, power: int) -> "Fq12":
        """x -> x^(p^power) via precomputed coefficients."""
        out = self
        for _ in range(power % 12):
            out = out._frobenius_once()
        return out

    def _frobenius_once(self) -> "Fq12":
        def frob2(x: Fq2) -> Fq2:
            return x.conjugate()

        c0 = Fq6(
            frob2(self.c0.c0),
            frob2(self.c0.c1) * _FROB6_C1[1],
            frob2(self.c0.c2) * _FROB6_C2[1],
        )
        c1 = Fq6(
            frob2(self.c1.c0) * _FROB12_C1[1],
            frob2(self.c1.c1) * _FROB6_C1[1] * _FROB12_C1[1],
            frob2(self.c1.c2) * _FROB6_C2[1] * _FROB12_C1[1],
        )
        return Fq12(c0, c1)

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash((self.c0, self.c1))


# Frobenius coefficients: gamma = (u+1)^((p-1)/k) for the tower maps.
_NONRESIDUE = Fq2(1, 1)
_FROB6_C1 = [_NONRESIDUE.pow(((P**i) - 1) // 3) for i in range(2)]
_FROB6_C2 = [_NONRESIDUE.pow((2 * ((P**i) - 1)) // 3) for i in range(2)]
_FROB12_C1 = [_NONRESIDUE.pow(((P**i) - 1) // 6) for i in range(2)]

Fq12.ONE = Fq12(Fq6.ONE, Fq6.ZERO)
