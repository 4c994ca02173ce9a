// BLS12-381 G1 arithmetic for the port's G1 kernels (g1_kernels.cu): the
// base field Fq, the complete projective addition law, and the per-thread
// bodies of the three kernels (tree aggregation, running sum, ladder).
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
//     b3 = 12), in the JAX package's order of operations, so a sum of
//     the same inputs in the same tree order gives the same X, Y, Z mod q.
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
// product by 2^390 mod q takes x * 2^384 to x * 2^390.
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

// A row (signed-loose limbs) -> this header's form: (row value) * k *
// 2^-768 mod q.  k = K_MONT_IN for 2^390-Montgomery rows, K_PLAIN_IN for
// plain rows.
G1_HD G1_INLINE Fe row_to_fe(const int32_t* row, const Fe& k) {
  uint32_t wide[NW + 1];
  row_to_wide(row, wide);
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

G1_HD G1_INLINE Point load_point(const int32_t* xs, const int32_t* ys,
                                 const int32_t* zs, int i, const Fe& k) {
  Point p;
  p.x = row_to_fe(xs + i * NLIMBS, k);
  p.y = row_to_fe(ys + i * NLIMBS, k);
  p.z = row_to_fe(zs + i * NLIMBS, k);
  return p;
}

G1_HD G1_INLINE void store_point(const Point& p, int32_t* ox, int32_t* oy,
                                 int32_t* oz, int i) {
  fe_to_row(p.x, ox + i * NLIMBS);
  fe_to_row(p.y, oy + i * NLIMBS);
  fe_to_row(p.z, oz + i * NLIMBS);
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

// ---- the kernels' bodies ---------------------------------------------------------

// Tree aggregation of `batch` points (a power of two) to one, in the JAX
// package's order (_tree_reduce: the first half plus the second half,
// level after level).  `team` runs a level's pairs over its threads
// (each(n, f) calls f(i) for the i < n it owns) and sync() is the barrier
// between levels.  `scratch` holds batch / 2 points.  `plain` says the
// rows are plain (else 2^390-Montgomery).  The sum lands in row 0 of
// ox, oy, oz, as a canonical 2^390-Montgomery row.
template <class Team>
G1_HD void aggregate_tree(const Team& team, const int32_t* xs,
                          const int32_t* ys, const int32_t* zs, int batch,
                          int plain, Point* scratch, int32_t* ox, int32_t* oy,
                          int32_t* oz) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Fe k_plain = {{G1_K_PLAIN_IN}};
  const Fe k = plain ? k_plain : k_mont;
  if (batch == 1) {
    team.each(1, [&](int) { store_point(load_point(xs, ys, zs, 0, k), ox, oy, oz, 0); });
    return;
  }
  int half = batch / 2;
  team.each(half, [&](int i) {
    scratch[i] = point_add(load_point(xs, ys, zs, i, k),
                           load_point(xs, ys, zs, i + half, k));
  });
  team.sync();
  for (half /= 2; half >= 1; half /= 2) {
    team.each(half, [&](int i) { scratch[i] = point_add(scratch[i], scratch[i + half]); });
    team.sync();
  }
  team.each(1, [&](int) { store_point(scratch[0], ox, oy, oz, 0); });
}

// acc <- acc + (x : y : 1): acc is three canonical (or loose)
// 2^390-Montgomery rows (X, Y, Z, 30 limbs each, in place), the point's
// coordinates plain and canonical.
G1_HD G1_INLINE void running_add(int32_t* acc, const Affine& p) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Fe r2 = {{G1_R2}};
  const Point a = load_point(acc, acc + NLIMBS, acc + 2 * NLIMBS, 0, k_mont);
  Fe px, py;
  for (int j = 0; j < NW; ++j) {
    px.w[j] = p.x[j];
    py.w[j] = p.y[j];
  }
  const Point b{fe_mul(px, r2), fe_mul(py, r2), fe_one()};
  store_point(point_add(a, b), acc, acc + NLIMBS, acc + 2 * NLIMBS, 0);
}

// Lane `lane` of the batched ladder: [k]P by MSB-first double-and-add,
// the add's result taken where the scalar's bit is set (bits[i * batch +
// lane], i < nbits), as hotstuff_tpu/tpu/bls.py _scalar_mult_kernel.
// Points are 2^390-Montgomery rows; the result is a canonical row.
G1_HD G1_INLINE void scalar_mult_lane(const int32_t* bits, int nbits,
                                      int batch, int lane, const int32_t* xs,
                                      const int32_t* ys, const int32_t* zs,
                                      int32_t* ox, int32_t* oy, int32_t* oz) {
  const Fe k_mont = {{G1_K_MONT_IN}};
  const Point p = load_point(xs, ys, zs, lane, k_mont);
  Point acc{fe_zero(), fe_one(), fe_zero()};
  for (int i = 0; i < nbits; ++i) {
    acc = point_add(acc, acc);
    const Point added = point_add(acc, p);
    if (bits[i * batch + lane] != 0) acc = added;
  }
  store_point(acc, ox, oy, oz, lane);
}

}  // namespace g1
