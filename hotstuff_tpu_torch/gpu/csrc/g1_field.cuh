// BLS12-381 G1 arithmetic for the port's G1 kernels (g1_kernels.cu): the
// base field Fq, the complete projective addition law (one thread, and a
// team of six threads), and the bodies of the three kernels (tree
// aggregation, running sum, ladder).
//
// Everything here is __host__ __device__, so the same code is the body of
// the CUDA kernels and of a host build (g1_host_lanes.cpp, compiled with
// g++ by the CPU tests).
//
// What it computes is the JAX package's (hotstuff_tpu/tpu/bls.py), not
// how.  The JAX code keeps Fq in 30 signed-loose 13-bit limbs in int32
// with Montgomery radix 2^390, and renormalises long chains with
// _freshen.  Here:
//   * Fq is 12 little-endian 32-bit words, every value canonical (< q)
//     after every operation;
//   * products are exact CIOS Montgomery multiplications with radix
//     R = 2^384 (32x32 -> 64-bit multiply-adds), then one conditional
//     subtraction of q; additions and subtractions end with one
//     conditional subtraction or addition of q; scaling by b3 = 12 is
//     four additions.  No magnitude grows, so a chain of any length needs
//     no renormalisation;
//   * points are homogeneous projective (X : Y : Z) with the complete
//     formulas of Renes-Costello-Batina 2015, Algorithm 7 (a = 0,
//     b3 = 12), so a sum of the same inputs in the same tree order gives
//     the same X, Y, Z mod q.  Every value being canonical, any two
//     schedules of the same formulas give the same words.
//
// The team addition (team_point_add) is the card's: Algorithm 7's twelve
// products are two stages of six independent ones, so six threads (the
// members of a team) take one product each, and a point addition is a
// chain of two products instead of twelve.  A Team gives:
//   * stage(n, f): f(m) for each member m < n, then the team's barrier
//     (on the card: f(this thread's member), then __syncwarp over the
//     team's lanes; on the host: the members one after another, forward
//     or reversed, which checks that no member reads another's output of
//     the same stage);
//   * slots(): the team's TeamSlots, its exchange slots (shared memory
//     on the card): the two operands, stage 1's outputs and stage 2's.
// Every member runs the same instructions on operands it selects by
// index, so the six members of a team (and the teams of a warp) do not
// diverge.
//
// The interface keeps the JAX package's layout: each coordinate a row of
// 30 int32 limbs of 13 bits, in Montgomery form for radix 2^390 (or
// plain, where the JAX function takes plain rows).  Input rows may be
// signed-loose, as the JAX functions leave them; output rows are
// canonical (every limb in [0, 2^13), value < q).  Conversion at the
// edges: a row's integer T (13 words, two's complement) is reduced by one
// Montgomery reduction (T * 2^-384 mod q) and one product with a constant
// that lands it in this header's form (x * 2^384): 2^762 mod q for a
// 2^390-Montgomery row, 2^1152 mod q for a plain row.  Output: one
// product by 2^390 mod q takes x * 2^384 to x * 2^390.  In the team
// bodies each member converts one coordinate.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define G1_HD __host__ __device__
#define G1_INLINE __forceinline__
#define G1_NOINLINE __noinline__
#else
#define G1_HD
#define G1_INLINE inline __attribute__((always_inline))
#define G1_NOINLINE __attribute__((noinline))
#endif

namespace g1 {

constexpr int NW = 12;         // 32-bit words of an Fq element
constexpr int NLIMBS = 30;     // 13-bit limbs of an interface row
constexpr int LIMB_BITS = 13;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;
constexpr uint32_t QINV = 0xfffcfffdu;  // -q^-1 mod 2^32
constexpr int B3 = 12;                  // 3b for y^2 = x^3 + 4

// q, and the constants of the edge conversions, as word lists (least
// significant first).  Macros, so each use is an immediate operand.
#define G1_Q                                                              \
  0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,        \
      0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,    \
      0x397fe69au, 0x1a0111eau
// 2^384 mod q: the element 1 in this header's form
#define G1_ONE                                                            \
  0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,        \
      0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,    \
      0xfa80e493u, 0x15f65ec3u
// 2^768 mod q: x -> x * 2^384 in one product
#define G1_R2                                                             \
  0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u,        \
      0x8de5476cu, 0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u,    \
      0x92cae3aau, 0x11988fe5u
// 2^762 mod q: a 2^390-Montgomery row after the reduction
#define G1_K_MONT_IN                                                      \
  0xd0709308u, 0x9582c47cu, 0xa79ba413u, 0x4a357b99u, 0x628187c5u,        \
      0x9462ac81u, 0x35561b88u, 0x85d56c6au, 0x1732ca8fu, 0x9065c585u,    \
      0xef9f194du, 0x12f7271fu
// 2^1152 mod q: a plain row after the reduction
#define G1_K_PLAIN_IN                                                     \
  0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu,        \
      0x9a53352au, 0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u,    \
      0x91755d4du, 0x0aa63460u
// 2^390 mod q: x * 2^384 -> x * 2^390 in one product
#define G1_K_OUT                                                          \
  0x00d1ff2eu, 0x46760000u, 0x9b4800acu, 0x84b80337u, 0xe882431cu,        \
      0x0dd9a7e0u, 0xb683dcf8u, 0xc26c26d0u, 0x63c4a5eeu, 0x29f14576u,    \
      0x7f3e804bu, 0x015de996u

struct Fe {
  uint32_t w[NW];
};

struct Point {
  Fe x, y, z;
};

// An affine point of plain canonical coordinates, passed by value.
struct Affine {
  uint32_t x[NW];
  uint32_t y[NW];
};

G1_HD G1_INLINE Fe fe_zero() { return Fe{{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}}; }
G1_HD G1_INLINE Fe fe_one() { return Fe{{G1_ONE}}; }

// a - q if a >= q (a < 2q)
G1_HD G1_INLINE void fe_reduce_once(Fe& a) {
  const uint32_t q[NW] = {G1_Q};
  uint32_t d[NW];
  uint32_t borrow = 0;
  for (int j = 0; j < NW; ++j) {
    const uint64_t t = (uint64_t)a.w[j] - q[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t take = borrow - 1u;  // all ones when a >= q
  for (int j = 0; j < NW; ++j) a.w[j] = (d[j] & take) | (a.w[j] & ~take);
}

G1_HD G1_INLINE Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  uint64_t c = 0;
  for (int j = 0; j < NW; ++j) {
    c += (uint64_t)a.w[j] + b.w[j];
    r.w[j] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_once(r);  // a + b < 2q < 2^382: no carry out of the top word
  return r;
}

G1_HD G1_INLINE Fe fe_sub(const Fe& a, const Fe& b) {
  const uint32_t q[NW] = {G1_Q};
  Fe r;
  uint32_t borrow = 0;
  for (int j = 0; j < NW; ++j) {
    const uint64_t t = (uint64_t)a.w[j] - b.w[j] - borrow;
    r.w[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t add = 0u - borrow;  // all ones when a < b
  uint64_t c = 0;
  for (int j = 0; j < NW; ++j) {
    c += (uint64_t)r.w[j] + (q[j] & add);
    r.w[j] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a * b * 2^-384 mod q, by CIOS (a, b < q; q < 2^384 / 4, so the result
// before the last subtraction is < 2q).
G1_HD G1_INLINE Fe fe_mul(const Fe& a, const Fe& b) {
  const uint32_t q[NW] = {G1_Q};
  uint32_t t[NW + 2];
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * QINV;
    c = ((uint64_t)m * q[0] + t[0]) >> 32;
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * q[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  Fe r;
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  fe_reduce_once(r);
  return r;
}

G1_HD G1_INLINE Fe fe_mul12(const Fe& a) {
  const Fe a2 = fe_add(a, a);
  const Fe a4 = fe_add(a2, a2);
  return fe_add(fe_add(a4, a4), a4);
}

// ---- edge conversions -------------------------------------------------------

// The integer of a row of 30 signed 13-bit limbs, as 13 words of two's
// complement (|value| < 2^415).
G1_HD G1_INLINE void row_to_wide(const int32_t* row, uint32_t out[NW + 1]) {
  int64_t acc = 0;
  int bits = 0;
  int w = 0;
  for (int i = 0; i < NLIMBS; ++i) {
    acc += (int64_t)row[i] * ((int64_t)1 << bits);
    bits += LIMB_BITS;
    while (bits >= 32) {
      out[w++] = (uint32_t)acc;
      acc >>= 32;  // arithmetic: borrows move up
      bits -= 32;
    }
  }
  while (w < NW + 1) {
    out[w++] = (uint32_t)acc;
    acc >>= 32;
  }
}

// T * 2^-384 mod q for a non-negative T of 13 words, canonical.
G1_HD G1_INLINE Fe redc_wide(const uint32_t T[NW + 1]) {
  const uint32_t q[NW] = {G1_Q};
  uint32_t t[2 * NW + 2];
  for (int j = 0; j < 2 * NW + 2; ++j) t[j] = j < NW + 1 ? T[j] : 0u;
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * QINV;
    uint64_t c = 0;
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)m * q[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    for (int k = i + NW; k < 2 * NW + 2; ++k) {
      c += t[k];
      t[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  // (T + m q) / 2^384 < 2^32 + q < 2q: twelve words, one subtraction
  Fe r;
  for (int j = 0; j < NW; ++j) r.w[j] = t[NW + j];
  fe_reduce_once(r);
  return r;
}

// A 13-word two's complement integer T -> this header's form: T * k *
// 2^-768 mod q (wide is overwritten).
G1_HD G1_INLINE Fe wide_to_fe(uint32_t wide[NW + 1], const Fe& k) {
  const bool negative = (wide[NW] >> 31) != 0;
  if (negative) {  // |T|: two's complement negation over 13 words
    uint64_t c = 1;
    for (int j = 0; j < NW + 1; ++j) {
      c += (uint32_t)~wide[j];
      wide[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  const Fe r = fe_mul(redc_wide(wide), k);
  return negative ? fe_sub(fe_zero(), r) : r;
}

// A row (signed-loose limbs) -> this header's form: (row value) * k *
// 2^-768 mod q.  k = K_MONT_IN for 2^390-Montgomery rows, K_PLAIN_IN for
// plain rows.
G1_HD G1_INLINE Fe row_to_fe(const int32_t* row, const Fe& k) {
  uint32_t wide[NW + 1];
  row_to_wide(row, wide);
  return wide_to_fe(wide, k);
}

// This header's form -> a canonical 2^390-Montgomery row.
G1_HD G1_INLINE void fe_to_row(const Fe& a, int32_t* row) {
  const Fe k = {{G1_K_OUT}};
  const Fe v = fe_mul(a, k);
  for (int i = 0; i < NLIMBS; ++i) {
    const int bit = i * LIMB_BITS;
    const int w = bit / 32;
    const int off = bit % 32;
    uint64_t lo = v.w[w] >> off;
    if (w + 1 < NW) lo |= (uint64_t)v.w[w + 1] << (32 - off);
    row[i] = (int32_t)(lo & LIMB_MASK);
  }
}

// ---- the complete addition law ------------------------------------------------

// Renes-Costello-Batina 2015, Algorithm 7 (a = 0, b3 = 12), in the order
// of hotstuff_tpu/tpu/bls.py point_add.  Valid for every pair of points
// of E(Fq) (its group has no point of order 2), the identity (0 : 1 : 0),
// P == Q and P == -Q included.  p and q may alias.
G1_HD G1_NOINLINE Point point_add(const Point& p, const Point& q) {
  Fe t0 = fe_mul(p.x, q.x);
  Fe t1 = fe_mul(p.y, q.y);
  Fe t2 = fe_mul(p.z, q.z);
  Fe t3 = fe_mul(fe_add(p.x, p.y), fe_add(q.x, q.y));
  t3 = fe_sub(t3, fe_add(t0, t1));
  Fe t4 = fe_mul(fe_add(p.y, p.z), fe_add(q.y, q.z));
  t4 = fe_sub(t4, fe_add(t1, t2));
  Fe x3 = fe_mul(fe_add(p.x, p.z), fe_add(q.x, q.z));
  Fe y3 = fe_sub(x3, fe_add(t0, t2));
  x3 = fe_add(t0, t0);
  t0 = fe_add(x3, t0);
  t2 = fe_mul12(t2);
  Fe z3 = fe_add(t1, t2);
  t1 = fe_sub(t1, t2);
  y3 = fe_mul12(y3);
  x3 = fe_mul(t4, y3);
  t2 = fe_mul(t3, t1);
  x3 = fe_sub(t2, x3);
  y3 = fe_mul(y3, t0);
  t1 = fe_mul(t1, z3);
  y3 = fe_add(t1, y3);
  t0 = fe_mul(t0, t3);
  z3 = fe_mul(z3, t4);
  z3 = fe_add(z3, t0);
  return Point{x3, y3, z3};
}

// ---- the team addition ------------------------------------------------------------

constexpr int kMembers = 6;  // threads of a team: one product each a stage

// A team's exchange slots.  a, b: the operands of the tree's first level
// (and the ladder's and the running sum's accumulator and point); s1:
// stage 1's six products t0, t1, t2, t3, t4, m5 (m5 = (X1 + Z1)(X2 +
// Z2)), then 3 t0, 12 t0, 12 t2, 12 m5 and a zero; s2: stage 2's six
// products.
struct TeamSlots {
  Fe a[3];
  Fe b[3];
  Fe s1[11];
  Fe s2[kMembers];
};

namespace team_detail {

constexpr int T0 = 0, T1 = 1, T2 = 2, T3 = 3, T4 = 4, M5 = 5;
constexpr int T0x3 = 6, T0x12 = 7, T2x12 = 8, M5x12 = 9, ZERO = 10;

// Algorithm 7 between its two stages of products, each value as
// (s1[i] + s1[j]) - (s1[k] + s1[l]) (the x12 scalings are linear, so
// stage 1 scales the products and nothing scales a difference):
//   t3' = t3 - (t0 + t1)          t4' = t4 - (t1 + t2)
//   y3' = 12 m5 - (12 t0 + 12 t2) t0' = 3 t0
//   t1' = t1 - 12 t2              z3' = t1 + 12 t2
constexpr int kMid[6][4] = {
    {T3, ZERO, T0, T1},    {T4, ZERO, T1, T2},       {M5x12, ZERO, T0x12, T2x12},
    {T0x3, ZERO, ZERO, ZERO}, {T1, ZERO, T2x12, ZERO}, {T1, T2x12, ZERO, ZERO},
};
// Stage 2, member m multiplies kMid[kPair[m][0]] by kMid[kPair[m][1]]:
// x3 = t4' y3', t2 = t3' t1', y3 = y3' t0', t1 = t1' z3', t0 = t0' t3',
// z3 = z3' t4'; then X3 = t2 - x3, Y3 = t1 + y3, Z3 = z3 + t0.
constexpr int kPair[kMembers][2] = {{1, 2}, {0, 4}, {2, 3}, {4, 5}, {3, 0}, {5, 1}};
// Stage 1, member m multiplies (P1[i] + P1[j]) by (P2[i] + P2[j]), i, j =
// kSum[m] (3: zero): X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
// (X1+Z1)(X2+Z2).
constexpr int kSum[kMembers][2] = {{0, 3}, {1, 3}, {2, 3}, {0, 1}, {1, 2}, {0, 2}};

// The tables as nibbles, member m's at bits 4m..4m+3, so a member reads
// its indices with a shift (a table indexed by the member would be a
// local array on the card).
constexpr uint32_t pack_sum(int which) {
  uint32_t r = 0;
  for (int m = 0; m < kMembers; ++m) r |= (uint32_t)kSum[m][which] << (4 * m);
  return r;
}
constexpr uint32_t pack_mid(int side, int which) {
  uint32_t r = 0;
  for (int m = 0; m < kMembers; ++m) r |= (uint32_t)kMid[kPair[m][side]][which] << (4 * m);
  return r;
}
constexpr uint32_t kSumI = pack_sum(0), kSumJ = pack_sum(1);
constexpr uint32_t kL0 = pack_mid(0, 0), kL1 = pack_mid(0, 1), kL2 = pack_mid(0, 2), kL3 = pack_mid(0, 3);
constexpr uint32_t kR0 = pack_mid(1, 0), kR1 = pack_mid(1, 1), kR2 = pack_mid(1, 2), kR3 = pack_mid(1, 3);

G1_HD G1_INLINE int nib(uint32_t packed, int m) { return (int)((packed >> (4 * m)) & 15u); }

// p[i] + p[j], p[3] read as zero
G1_HD G1_INLINE Fe coord_sum(const Fe* p, int i, int j) {
  Fe y = p[j % 3];
  const uint32_t keep = 0u - (uint32_t)(j < 3);
  for (int w = 0; w < NW; ++w) y.w[w] &= keep;
  return fe_add(p[i], y);
}

G1_HD G1_INLINE Fe mid(const Fe* s1, int i, int j, int k, int l) {
  return fe_sub(fe_add(s1[i], s1[j]), fe_add(s1[k], s1[l]));
}

}  // namespace team_detail

// out <- p1 + p2 (3 coordinates each), Algorithm 7 over the team: stage 1
// (six products), stage 2 (six products of sums of stage 1's), then three
// members combine the pairs; out is written only when `take` (uniform over
// the team).  p1, p2 and out may alias one another; they may lie in the
// team's slots or in memory every member reads.  Equal, limb for limb, to
// point_add(p1, p2).
template <class Team>
G1_HD G1_INLINE void team_point_add(const Team& team, const Fe* p1, const Fe* p2,
                                    Fe* out, bool take) {
  using namespace team_detail;
  TeamSlots& sl = team.slots();
  team.stage(kMembers, [&](int m) {
    const int i = nib(kSumI, m), j = nib(kSumJ, m);
    const Fe v = fe_mul(coord_sum(p1, i, j), coord_sum(p2, i, j));
    const Fe v3 = fe_add(fe_add(v, v), v);
    const Fe v6 = fe_add(v3, v3);
    const Fe v12 = fe_add(v6, v6);
    sl.s1[m] = v;
    if (m == T0) {
      sl.s1[T0x3] = v3;
      sl.s1[T0x12] = v12;
      sl.s1[ZERO] = fe_zero();
    }
    if (m == T2) sl.s1[T2x12] = v12;
    if (m == M5) sl.s1[M5x12] = v12;
  });
  team.stage(kMembers, [&](int m) {
    const Fe l = mid(sl.s1, nib(kL0, m), nib(kL1, m), nib(kL2, m), nib(kL3, m));
    const Fe r = mid(sl.s1, nib(kR0, m), nib(kR1, m), nib(kR2, m), nib(kR3, m));
    sl.s2[m] = fe_mul(l, r);
  });
  team.stage(3, [&](int c) {  // X3 = s2[1] - s2[0], Y3 = s2[3] + s2[2], Z3 = s2[5] + s2[4]
    const Fe hi = sl.s2[2 * c + 1], lo = sl.s2[2 * c];
    const Fe diff = fe_sub(hi, lo), sum = fe_add(hi, lo);
    if (take) out[c] = c == 0 ? diff : sum;
  });
}

G1_HD G1_INLINE const int32_t* coord_rows(const int32_t* xs, const int32_t* ys,
                                          const int32_t* zs, int c) {
  return c == 0 ? xs : c == 1 ? ys : zs;
}

G1_HD G1_INLINE int32_t* coord_rows(int32_t* xs, int32_t* ys, int32_t* zs, int c) {
  return c == 0 ? xs : c == 1 ? ys : zs;
}

// ---- the kernels' bodies ---------------------------------------------------------

// Tree aggregation of `batch` points (a power of two) to one, in the JAX
// package's order (_tree_reduce: the first half plus the second half,
// level after level).  Level l pairs index i with i + batch / 2^l, so
// after log2(L) levels node g holds the sum of the leaves g, g + G,
// g + 2G, ... (G = batch / L) in that same order: a subtree.  The card
// sums each subtree in a block of its own (tree_block), then the last
// block to finish sums the G partials (tree_final).  tree_blocks(batch)
// is G: one pair a team at the first level, kTreeTeams teams a block.
// `teams.each(n, f)` calls f(team, i) for the pairs i < n its teams own
// (a team a pair at a time), and `teams.sync()` is the barrier between
// levels.  The first level's six row conversions (two points) are one a
// member.  `plain` says the rows are plain (else 2^390-Montgomery).  The
// sum lands in row 0 of ox, oy, oz, as a canonical 2^390-Montgomery row.
constexpr int kTreeTeams = 16;

G1_HD G1_INLINE int tree_blocks(int batch) {
  return batch > 2 * kTreeTeams ? batch / (2 * kTreeTeams) : 1;
}

// Block g of G: the leaves g + G t (t < L = batch / G, L >= 2) to one
// point, in the block's region of `scratch` (L / 2 points from
// 3 g (L / 2)), whose first point it ends as.
template <class Teams>
G1_HD void tree_block(const Teams& teams, int g, int G, const int32_t* xs,
                      const int32_t* ys, const int32_t* zs, int batch,
                      int plain, Fe* scratch) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Fe k_plain = {{G1_K_PLAIN_IN}};
  const Fe k = plain ? k_plain : k_mont;
  int half = batch / G / 2;
  Fe* region = scratch + 3 * g * half;
  teams.each(half, [&](const auto& team, int t) {
    TeamSlots& sl = team.slots();
    team.stage(kMembers, [&](int m) {
      const int c = m % 3;
      const int leaf = g + G * (m < 3 ? t : t + half);
      (m < 3 ? sl.a : sl.b)[c] = row_to_fe(coord_rows(xs, ys, zs, c) + leaf * NLIMBS, k);
    });
    team_point_add(team, sl.a, sl.b, region + 3 * t, true);
  });
  teams.sync();
  for (half /= 2; half >= 1; half /= 2) {
    teams.each(half, [&](const auto& team, int t) {
      team_point_add(team, region + 3 * t, region + 3 * (t + half), region + 3 * t, true);
    });
    teams.sync();
  }
}

// The G partials (each at the start of its block's region, L / 2 points
// apart) to the sum, stored as canonical rows.
template <class Teams>
G1_HD void tree_final(const Teams& teams, int G, int L, Fe* scratch,
                      int32_t* ox, int32_t* oy, int32_t* oz) {
  const int stride = 3 * (L / 2);
  for (int half = G / 2; half >= 1; half /= 2) {
    teams.each(half, [&](const auto& team, int g) {
      team_point_add(team, scratch + stride * g, scratch + stride * (g + half),
                     scratch + stride * g, true);
    });
    teams.sync();
  }
  teams.each(1, [&](const auto& team, int) {
    team.stage(3, [&](int c) { fe_to_row(scratch[c], coord_rows(ox, oy, oz, c)); });
  });
}

// A batch of one: its row converted and stored.
template <class Teams>
G1_HD void tree_one(const Teams& teams, const int32_t* xs, const int32_t* ys,
                    const int32_t* zs, int plain, int32_t* ox, int32_t* oy,
                    int32_t* oz) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Fe k_plain = {{G1_K_PLAIN_IN}};
  const Fe k = plain ? k_plain : k_mont;
  teams.each(1, [&](const auto& team, int) {
    team.stage(3, [&](int c) {
      fe_to_row(row_to_fe(coord_rows(xs, ys, zs, c), k), coord_rows(ox, oy, oz, c));
    });
  });
}

// acc <- acc + (x : y : 1) on a team: acc is three canonical (or loose)
// 2^390-Montgomery rows (X, Y, Z, 30 limbs each, in place), the point's
// coordinates plain and canonical.  One stage converts the six
// coordinates, one a member, into the slots (members 0-2 the
// accumulator's rows into a, members 3-5 the point's x, y and 1 into b),
// team_point_add sums them into a, and members 0-2 store a's
// coordinates back as rows.  Every member of the load stage runs one
// instruction stream: only the fill of its 13-word integer differs (a
// row's limbs, or a plain value's 12 words), then the same reduction and
// product, by K_MONT_IN for a row and K_PLAIN_IN for a plain value
// (v * 2^1152 * 2^-768 = v * 2^384, what fe_mul(v, R2) gives, and
// 1 -> fe_one()).  Equal, limb for limb, to the one-thread running sum
// of g1_host_lanes.cpp.
template <class Team>
G1_HD G1_INLINE void team_running_add(const Team& team, int32_t* acc, const Affine& p) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Fe k_plain = {{G1_K_PLAIN_IN}};
  TeamSlots& sl = team.slots();
  team.stage(kMembers, [&](int m) {
    uint32_t wide[NW + 1];
    if (m < 3) {
      row_to_wide(acc + m * NLIMBS, wide);
    } else {
      for (int j = 0; j < NW; ++j) wide[j] = m == 3 ? p.x[j] : m == 4 ? p.y[j] : (uint32_t)(j == 0);
      wide[NW] = 0;
    }
    (m < 3 ? sl.a : sl.b)[m % 3] = wide_to_fe(wide, m < 3 ? k_mont : k_plain);
  });
  team_point_add(team, sl.a, sl.b, sl.a, true);
  team.stage(3, [&](int c) { fe_to_row(sl.a[c], acc + c * NLIMBS); });
}

// Lane `lane` of the batched ladder on one team: [k]P by MSB-first
// double-and-add, the add's result taken where the scalar's bit is set
// (bits[i * batch + lane], i < nbits), as hotstuff_tpu/tpu/bls.py
// _scalar_mult_kernel.  The accumulator and P live in the team's slots
// (a, b).  Points are 2^390-Montgomery rows; the result is stored as a
// canonical row.
template <class Team>
G1_HD void scalar_mult_lane(const Team& team, const int32_t* bits, int nbits,
                            int batch, int lane, const int32_t* xs,
                            const int32_t* ys, const int32_t* zs, int32_t* ox,
                            int32_t* oy, int32_t* oz) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  TeamSlots& sl = team.slots();
  team.stage(kMembers, [&](int m) {
    if (m < 3)
      sl.b[m] = row_to_fe(coord_rows(xs, ys, zs, m) + lane * NLIMBS, k_mont);
    else
      sl.a[m - 3] = m == 4 ? fe_one() : fe_zero();
  });
  for (int i = 0; i < nbits; ++i) {
    team_point_add(team, sl.a, sl.a, sl.a, true);
    team_point_add(team, sl.a, sl.b, sl.a, bits[i * batch + lane] != 0);
  }
  team.stage(3, [&](int c) { fe_to_row(sl.a[c], coord_rows(ox, oy, oz, c) + lane * NLIMBS); });
}

}  // namespace g1
