// GF(2^255-19) field, Edwards25519 point formulas and the team schedule
// of the fused verifier: the Straus scan and the compressed-equality
// epilogue, one signature on a team of eight threads.
//
// Everything here is __host__ __device__, so the same code is the body of
// the CUDA kernels (dsm_kernels.cu) and of a host build (host_lanes.cpp,
// compiled with g++ by the CPU tests).
//
// The arithmetic is the JAX package's, limb for limb
// (hotstuff_tpu/tpu/pallas_dsm.py, _dsm_scan / _compressed_equals_t):
//   * 20 little-endian limbs of 13 bits in int32_t;
//   * products: int32 multiply-adds into 39 column sums (products
//     < 2^26.3, column sums < 2^30.6), fold of columns 20..38 by 608,
//     then FOUR parallel carry passes; add / sub / doubling: TWO passes
//     (bounds in hotstuff_tpu/tpu/field.py, carry());
//   * squares by 210 products (cross terms once, doubled): limbs are
//     non-negative, so every partial column sum stays below the final one
//     and each column is the same integer as in the 400-product form;
//     the same holds for a column summed in any order or split between
//     threads;
//   * sub(a, b) = a + (SUB_PAD - b), SUB_PAD = 8p split to dominate any
//     loose-normalized limb;
//   * table points carry T pre-multiplied by 2d, so the c-term of an
//     addition is one multiply; the need_t schedule skips T where no
//     later step reads it.
// Signed arithmetic matters: canonical() relies on >> of negative int32
// being an arithmetic shift (borrow chains), so limbs stay int32_t.
//
// The team schedule.  The Pallas kernel runs each point formula as waves
// of four independent products (_mul_wave_t): the four-processor formulas
// of Hisil, Wong, Carter and Dawson.  Here role r of a team computes the
// r-th product of each wave and the r-th linear term between waves; a
// role is a pair of threads that splits each field operation by limbs
// (see "pairs" below), so a team is eight threads.  A team's state
// (accumulator, [0..15]A table, exchange slots) is a Team in shared
// memory.  A step is a function of the role; the caller's Step object
// runs the four roles of a step before the next one starts: on the device
// each thread runs its own role and then __syncwarp(), on the host the
// roles run one after another in a chosen order.  Within a step no role
// reads a slot that another role writes in that step, so every order
// gives the same limbs; the CPU tests run the roles (and the halves of
// each pair) forward and in reverse to check that.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ED_HD __host__ __device__
#define ED_NOINLINE __noinline__
#else
#define ED_HD
#define ED_NOINLINE __attribute__((noinline))
#endif

#if defined(__CUDA_ARCH__)
#define ED_LDG(p) __ldg(p)
#else
#define ED_LDG(p) (*(p))
#endif

namespace ed25519 {

constexpr int NL = 20;             // limbs per field element
constexpr int FE = 24;             // slot stride in the team state: 96 B
constexpr int LIMB_BITS = 13;
constexpr int32_t MASK = (1 << LIMB_BITS) - 1;
constexpr int32_t FOLD = 19 * 32;  // 2^260 = 608 (mod p)
constexpr int TOP_SHIFT = 8;       // bit 255 sits at bit 8 of limb 19
constexpr int32_t TOP_MASK = (1 << TOP_SHIFT) - 1;
constexpr int32_t TOP_FOLD = 19;   // 2^255 = 19 (mod p)
constexpr int NSTEPS = 32;         // macro steps of the scan (8 bits each)
constexpr int ROLES = 4;           // products per wave: pairs per signature
constexpr int NTAB = 16;           // [0..15]A

// A point in the team state: X, Y, Z, T, one 16-byte-aligned slot each.
struct Pt {
  int32_t c[4][FE];
};

// Per block: the curve constant 2d and SUB_PAD.
struct Consts {
  int32_t d2[FE];
  int32_t subpad[FE];
};

// One signature's state.  lin holds the linear terms between waves, prod
// the products of a formula's first wave; q holds A with T*2d while the
// table is built, then each macro step's base-table row.  A role with no
// term of its own in a step computes one into its spare slot, which
// nothing reads: so every thread of the warp makes the same calls, and
// the pairs' shuffles and barriers run on a converged warp.
struct Team {
  Pt acc;
  Pt tab[NTAB];
  Pt q;
  int32_t lin[6][FE];
  int32_t prod[ROLES][FE];
  int32_t spare[ROLES][FE];
  int32_t win[NSTEPS];  // s byte | k high nibble << 8 | k low nibble << 12
  int32_t pad[4];
};
// An odd number of 16-byte units: the int4 loads of neighbouring teams
// fall on other banks.
static_assert(sizeof(Team) % 32 == 16, "Team must be an odd multiple of 16 B");
static_assert(sizeof(Consts) % 16 == 0, "Consts must keep Team 16-byte aligned");

// A signature's inputs: A = (ax..at)[sig] (batch-major [B][NL]), windows
// s_win / k_win limb-major [64][B], MSB first.
struct LaneIn {
  const int32_t* ax;
  const int32_t* ay;
  const int32_t* az;
  const int32_t* at;
  const int32_t* s_win;
  const int32_t* k_win;
};

// ---- pairs -----------------------------------------------------------------
//
// Every field operation runs on a pair of threads.  Half h owns limbs
// 10h..10h+9 of the result.  A product's half computes the 21 columns
// its limbs need: half 0 the columns 0..9 and 19..29 of a*b; half 1 the
// same columns of a'*b', where x'[i] = x[19 - i], which are the columns
// 38..29 and 19..9 of a*b.  So both halves run one instruction stream
// and need no column of the other.  Each parallel carry pass needs one
// value from the partner: half 0 sends limb 9's carry, half 1 the fold
// of bit 255 of limb 19.
//
// A Pair policy says how: N halves held by one caller; each(f) calls
// f(h, s) for the caller's halves (s indexes per-half storage); lead(f)
// calls f() on half 0 alone; swap(send, recv) hands each half its
// partner's value; sync() is a barrier of the pair.  On the device
// (dsm_kernels.cu) a thread is one half and swap is a shuffle; on the host
// (host_lanes.cpp) each() runs both halves.  Each field operation starts
// with sync(), so it may read what the pair's previous operation wrote.

constexpr int HALF = NL / 2;  // limbs a half owns
constexpr int NRC = 21;       // columns a half computes: 0..9, 19..29

ED_HD inline void fe_load(int32_t r[NL], const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int4* v = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int i = 0; i < NL / 4; ++i) {
    const int4 w = v[i];
    r[4 * i] = w.x;
    r[4 * i + 1] = w.y;
    r[4 * i + 2] = w.z;
    r[4 * i + 3] = w.w;
  }
#else
  for (int i = 0; i < NL; ++i) r[i] = p[i];
#endif
}

// Half h's limbs of a slot (8-byte aligned: slots are 16-byte aligned).
ED_HD inline void half_load(int32_t r[HALF], const int32_t* slot, int h) {
  const int32_t* p = slot + HALF * h;
#if defined(__CUDA_ARCH__)
  const int2* v = reinterpret_cast<const int2*>(p);
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) {
    const int2 w = v[i];
    r[2 * i] = w.x;
    r[2 * i + 1] = w.y;
  }
#else
  for (int i = 0; i < HALF; ++i) r[i] = p[i];
#endif
}

ED_HD inline void half_store(int32_t* slot, const int32_t r[HALF], int h) {
  int32_t* p = slot + HALF * h;
#if defined(__CUDA_ARCH__)
  int2* v = reinterpret_cast<int2*>(p);
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) v[i] = make_int2(r[2 * i], r[2 * i + 1]);
#else
  for (int i = 0; i < HALF; ++i) p[i] = r[i];
#endif
}

// x for half 0, x' (x'[i] = x[19 - i]) for half 1.
ED_HD inline void load_turned(int32_t r[NL], const int32_t* slot, int h) {
  int32_t v[NL];
  fe_load(v, slot);
#pragma unroll
  for (int i = 0; i < NL; ++i) r[i] = h ? v[NL - 1 - i] : v[i];
}

// rc[0..9] = columns 0..9 and rc[10..20] = columns 19..29 of a*b
// (220 products).
ED_HD inline void mul_cols(int32_t rc[NRC], const int32_t ra[NL],
                           const int32_t rb[NL]) {
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i <= c; ++i) acc += ra[i] * rb[c - i];
    rc[c] = acc;
  }
#pragma unroll
  for (int c = NL - 1; c <= NL + HALF - 1; ++c) {
    int32_t acc = 0;
#pragma unroll
    for (int i = c - (NL - 1); i < NL; ++i) acc += ra[i] * rb[c - i];
    rc[c - (NL - 1) + HALF] = acc;
  }
}

// The same columns of a*a by the pairs i <= j (115 products): limbs are
// non-negative, so each column is the same integer as in mul_cols.
ED_HD inline void sqr_cols(int32_t rc[NRC], const int32_t ra[NL]) {
  int32_t r2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) r2[i] = 2 * ra[i];
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    int32_t acc = c % 2 == 0 ? ra[c / 2] * ra[c / 2] : 0;
#pragma unroll
    for (int i = 0; 2 * i < c; ++i) acc += r2[i] * ra[c - i];
    rc[c] = acc;
  }
#pragma unroll
  for (int c = NL - 1; c <= NL + HALF - 1; ++c) {
    int32_t acc = c % 2 == 0 ? ra[c / 2] * ra[c / 2] : 0;
#pragma unroll
    for (int i = c - (NL - 1); 2 * i < c; ++i) acc += r2[i] * ra[c - i];
    rc[c - (NL - 1) + HALF] = acc;
  }
}

// Half h's limbs j = 10h + k before the carry passes: column j, plus the
// fold of column 20+j (weight 608 * 2^13j) with its low 13 bits at limb j
// and the rest at limb j+1, so every term stays within int32.  Half 1
// finds column c at turned column 38 - c.
ED_HD inline void fold_half(int32_t z[HALF], const int32_t rc[NRC], int h) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const int32_t col = h ? rc[2 * HALF - 1 - k] : rc[k];        // column j
    const int32_t lo = h ? (k < HALF - 1 ? rc[HALF - 2 - k] : 0)  // column 20+j
                         : rc[HALF + 1 + k];
    const int32_t hi = h ? rc[HALF - 1 - k]                       // column 19+j
                         : (k > 0 ? rc[HALF + k] : 0);
    z[k] = col + (lo & MASK) * FOLD + (hi >> LIMB_BITS) * FOLD;
  }
}

// `passes` parallel carry passes over the pair's limbs: every limb emits
// its carry from its value before the pass; limb 19 keeps 8 bits and
// sends the rest x19 to limb 0.
template <class Pair>
ED_HD inline void carry_half(const Pair& pr, int32_t (*z)[HALF], int passes) {
  for (int p = 0; p < passes; ++p) {
    int32_t send[Pair::N], recv[Pair::N];
    pr.each([&](int h, int s) {
      send[s] = (z[s][HALF - 1] >> (h ? TOP_SHIFT : LIMB_BITS)) * (h ? TOP_FOLD : 1);
    });
    pr.swap(send, recv);
    pr.each([&](int h, int s) {
      int32_t* x = z[s];
      int32_t c[HALF - 1];
#pragma unroll
      for (int k = 0; k < HALF - 1; ++k) c[k] = x[k] >> LIMB_BITS;
#pragma unroll
      for (int k = 0; k < HALF - 1; ++k) x[k] &= MASK;
      x[HALF - 1] &= h ? TOP_MASK : MASK;
#pragma unroll
      for (int k = HALF - 1; k >= 1; --k) x[k] += c[k - 1];
      x[0] += recv[s];
    });
  }
}

// ---- field: operands are slots (16-byte aligned, NL limbs used) -----------

// A field element from global memory (any alignment) into a slot.
template <class Pair>
ED_HD inline void fe_fetch(const Pair& pr, int32_t* out, const int32_t* src) {
  pr.each([&](int h, int) {
    int32_t r[HALF];
#pragma unroll
    for (int k = 0; k < HALF; ++k) r[k] = ED_LDG(src + HALF * h + k);
    half_store(out, r, h);
  });
}

template <class Pair>
ED_HD inline void fe_set_small(const Pair& pr, int32_t* out, int32_t v) {
  pr.each([&](int h, int) {
    int32_t r[HALF];
#pragma unroll
    for (int k = 0; k < HALF; ++k) r[k] = 0;
    r[0] = h ? 0 : v;
    half_store(out, r, h);
  });
}

// out = a * b (out may alias a or b): 400 products, fold, four carry
// passes.
template <class Pair>
ED_HD ED_NOINLINE void fe_mul(const Pair pr, int32_t* out, const int32_t* a,
                              const int32_t* b) {
  pr.sync();
  int32_t z[Pair::N][HALF];
  pr.each([&](int h, int s) {
    int32_t ra[NL], rb[NL], rc[NRC];
    load_turned(ra, a, h);
    load_turned(rb, b, h);
    mul_cols(rc, ra, rb);
    fold_half(z[s], rc, h);
  });
  carry_half(pr, z, 4);
  pr.each([&](int h, int s) { half_store(out, z[s], h); });
}

// out = a^2, limb for limb fe_mul(out, a, a), by 210 products (out may
// alias a).
template <class Pair>
ED_HD ED_NOINLINE void fe_sqr(const Pair pr, int32_t* out, const int32_t* a) {
  pr.sync();
  int32_t z[Pair::N][HALF];
  pr.each([&](int h, int s) {
    int32_t ra[NL], rc[NRC];
    load_turned(ra, a, h);
    sqr_cols(rc, ra);
    fold_half(z[s], rc, h);
  });
  carry_half(pr, z, 4);
  pr.each([&](int h, int s) { half_store(out, z[s], h); });
}

// out = x + y (sub = 0) or x + (subpad - y) (sub = 1), then two carry
// passes: the add and sub of the point formulas, and the doubling as
// x + x.  `sub` differs between the threads of a warp, so it selects by
// arithmetic, not by a branch; either way the sum is the same integer.
template <class Pair>
ED_HD ED_NOINLINE void fe_lin(const Pair pr, int32_t* out, const int32_t* x,
                              const int32_t* y, const int32_t* subpad,
                              int sub) {
  pr.sync();
  int32_t z[Pair::N][HALF];
  pr.each([&](int h, int s) {
    int32_t rx[HALF], ry[HALF], rp[HALF];
    half_load(rx, x, h);
    half_load(ry, y, h);
    half_load(rp, subpad, h);
    const int32_t m = -sub;  // 0 or all ones
#pragma unroll
    for (int k = 0; k < HALF; ++k) z[s][k] = rx[k] + ((rp[k] & m) + ((ry[k] ^ m) - m));
  });
  carry_half(pr, z, 2);
  pr.each([&](int h, int s) { half_store(out, z[s], h); });
}

// out = a^(2^n), n >= 1 (out may alias a).
template <class Pair>
ED_HD inline void fe_sqr_n(const Pair& pr, int32_t* out, const int32_t* a, int n) {
  fe_sqr(pr, out, a);
  for (int i = 1; i < n; ++i) fe_sqr(pr, out, out);
}

// out = a^(p-2) = a^-1 by the standard curve25519 addition chain: 265
// multiplies, 254 of them squarings.  `s` is scratch of 9 slots (stride
// FE); out may alias a.
template <class Pair>
ED_HD ED_NOINLINE void fe_pow_inv(const Pair pr, int32_t* out,
                                  const int32_t* a, int32_t* s) {
  int32_t* z2 = s;
  int32_t* z9 = s + FE;
  int32_t* z11 = s + 2 * FE;
  int32_t* z5 = s + 3 * FE;
  int32_t* z10 = s + 4 * FE;
  int32_t* z20 = s + 5 * FE;
  int32_t* z50 = s + 6 * FE;
  int32_t* z100 = s + 7 * FE;
  int32_t* t = s + 8 * FE;
  fe_sqr(pr, z2, a);
  fe_sqr_n(pr, t, z2, 2);
  fe_mul(pr, z9, t, a);
  fe_mul(pr, z11, z9, z2);
  fe_sqr(pr, t, z11);
  fe_mul(pr, z5, t, z9);  // 2^5 - 1
  fe_sqr_n(pr, t, z5, 5);
  fe_mul(pr, z10, t, z5);  // 2^10 - 1
  fe_sqr_n(pr, t, z10, 10);
  fe_mul(pr, z20, t, z10);  // 2^20 - 1
  fe_sqr_n(pr, t, z20, 20);
  fe_mul(pr, t, t, z20);  // 2^40 - 1
  fe_sqr_n(pr, t, t, 10);
  fe_mul(pr, z50, t, z10);  // 2^50 - 1
  fe_sqr_n(pr, t, z50, 50);
  fe_mul(pr, z100, t, z50);  // 2^100 - 1
  fe_sqr_n(pr, t, z100, 100);
  fe_mul(pr, t, t, z100);  // 2^200 - 1
  fe_sqr_n(pr, t, t, 50);
  fe_mul(pr, t, t, z50);  // 2^250 - 1
  fe_sqr_n(pr, t, t, 5);
  fe_mul(pr, out, t, z11);  // 2^255 - 21
}

// One sequential signed carry pass (arithmetic shift floors borrows).
ED_HD inline void fe_chain(int32_t z[NL]) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t x = z[i] + c;
    c = x >> LIMB_BITS;
    z[i] = x & MASK;
  }
}

// Loose normalized -> the unique value in [0, p), in place, on half 0
// (the borrow chains are sequential).
template <class Pair>
ED_HD ED_NOINLINE void fe_canonical(const Pair pr, int32_t* slot) {
  pr.sync();
  pr.lead([&] {
    int32_t z[NL], p[NL];
    fe_load(z, slot);
    // p = 2^255 - 19: limb 0 = 2^13 - 19, limbs 1..18 = 2^13 - 1, limb 19 = 2^8 - 1
    p[0] = MASK - 18;
#pragma unroll
    for (int i = 1; i < NL - 1; ++i) p[i] = MASK;
    p[NL - 1] = TOP_MASK;
    fe_chain(z);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // peel bit 255 (at most twice)
      const int32_t top = z[NL - 1] >> TOP_SHIFT;
      z[0] += top * TOP_FOLD;
      z[NL - 1] -= top << TOP_SHIFT;
      fe_chain(z);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int32_t d[NL];
      int32_t borrow = 0;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int32_t x = z[i] - p[i] + borrow;
        borrow = x >> LIMB_BITS;
        d[i] = x & MASK;
      }
      // no final borrow -> value >= p, keep value - p
#pragma unroll
      for (int i = 0; i < NL; ++i) z[i] = borrow >= 0 ? d[i] : z[i];
    }
    half_store(slot, z, 0);
    half_store(slot, z + HALF, 1);
  });
}

// ---- team steps ------------------------------------------------------------
//
// A Step object runs one step of the schedule: step(f) calls f(role) for
// the caller's roles, then waits for the team; step.pair is the Pair
// policy of the caller's field operations.

template <class V>
ED_HD inline V pick(int r, V v0, V v1, V v2, V v3) {
  return r == 0 ? v0 : r == 1 ? v1 : r == 2 ? v2 : v3;
}

// The second wave of both point formulas, from e, f, g, h in lin[0..3]:
// X = e f, Y = g h, Z = f g and, where need_t, T = e h (else T = 0).
// out may alias the formula's input point: no role reads it here.
template <class Step>
ED_HD void team_wave2(const Step& step, Team& t, Pt& out, bool need_t) {
  const auto& pr = step.pair;
  step([&](int r) {
    fe_mul(pr, r == 3 && !need_t ? t.spare[3] : out.c[r], t.lin[pick(r, 0, 2, 1, 0)],
           t.lin[pick(r, 1, 3, 2, 3)]);
    if (r == 3 && !need_t) fe_set_small(pr, out.c[3], 0);
  });
}

// out = p + q by add-2008-hwcd-3 (pallas_dsm._point_add_t): p with a plain
// T, q with T*2d.  out may alias p; q is never out.
template <class Step>
ED_HD void team_add(const Step& step, Team& t, const Consts& k, Pt& out,
                    const Pt& p, const Pt& q, bool need_t) {
  const auto& pr = step.pair;
  // Y1 - X1, Y1 + X1, Y2 - X2, Y2 + X2
  step([&](int r) {
    const Pt& s = r < 2 ? p : q;
    fe_lin(pr, t.lin[r], s.c[1], s.c[0], k.subpad, (r & 1) ^ 1);
  });
  // a = (Y1-X1)(Y2-X2), b = (Y1+X1)(Y2+X2), c = T1 T2d, zz = Z1 Z2
  step([&](int r) {
    fe_mul(pr, t.prod[r], r < 2 ? t.lin[r] : p.c[5 - r],
           r < 2 ? t.lin[r + 2] : q.c[5 - r]);
  });
  // e = b - a, h = b + a, d = 2 zz; role 3 spare
  step([&](int r) {
    fe_lin(pr, pick(r, t.lin[0], t.lin[3], t.lin[4], t.spare[3]), t.prod[r < 2 ? 1 : 3],
           t.prod[r < 2 ? 0 : 3], k.subpad, r == 0);
  });
  // f = d - c, g = d + c; roles 2 and 3 spare
  step([&](int r) {
    fe_lin(pr, r < 2 ? t.lin[r + 1] : t.spare[r], t.lin[4], t.prod[2], k.subpad, r == 0);
  });
  team_wave2(step, t, out, need_t);
}

// acc = 2 acc by dbl-2008-hwcd (pallas_dsm._point_double_t; the input T
// is not read).  With `row` set, the first step also copies that
// base-table row into q, one coordinate per role.
template <class Step>
ED_HD void team_double(const Step& step, Team& t, const Consts& k,
                       bool need_t, const int32_t* row) {
  const auto& pr = step.pair;
  Pt& p = t.acc;
  // a = X^2, b = Y^2, zz = Z^2, xy2 = (X + Y)^2 (X + Y by role 3, into
  // lin[5]; roles 0..2 spare)
  step([&](int r) {
    if (row != nullptr) fe_fetch(pr, t.q.c[r], row + r * NL);
    fe_lin(pr, r == 3 ? t.lin[5] : t.spare[r], p.c[0], p.c[1], k.subpad, 0);
    fe_sqr(pr, t.prod[r], r == 3 ? t.lin[5] : p.c[r]);
  });
  // h = a + b, g = a - b, c = 2 zz; role 3 spare
  step([&](int r) {
    fe_lin(pr, pick(r, t.lin[3], t.lin[2], t.lin[4], t.spare[3]), t.prod[r < 2 ? 0 : 2],
           t.prod[r < 2 ? 1 : 2], k.subpad, r == 1);
  });
  // e = h - xy2, f = c + g; roles 2 and 3 spare
  step([&](int r) {
    fe_lin(pr, r < 2 ? t.lin[r] : t.spare[r], t.lin[r == 0 ? 3 : 4],
           r == 0 ? t.prod[3] : t.lin[2], k.subpad, r == 0);
  });
  team_wave2(step, t, p, need_t);
}

// acc = [s]B + [k]A for signature `sig` (pallas_dsm._dsm_scan); T of the
// result is zero.  btab: [256][4][NL] multiples of B with T*2d.
template <class Step>
ED_HD void team_scan(const Step& step, Team& t, const Consts& k,
                     const int32_t* btab, const LaneIn& in, int sig,
                     int batch) {
  const auto& pr = step.pair;
  // A into tab[1] (plain T) and q (T*2d, the chain's second operand), the
  // identity into tab[0] and acc, the window codes of every macro step
  step([&](int r) {
    const int32_t* src = pick(r, in.ax, in.ay, in.az, in.at) + sig * NL;
    fe_fetch(pr, t.tab[1].c[r], src);
    fe_fetch(pr, t.q.c[r], src);
    fe_mul(pr, r == 3 ? t.q.c[3] : t.spare[r], t.tab[1].c[r], k.d2);
    fe_set_small(pr, t.tab[0].c[r], r == 1 || r == 2);
    fe_set_small(pr, t.acc.c[r], r == 1 || r == 2);
    pr.each([&](int h, int) {
      for (int i = 2 * r + h; i < NSTEPS; i += 2 * ROLES) {
        const int32_t s_hi = ED_LDG(in.s_win + (2 * i) * batch + sig);
        const int32_t s_lo = ED_LDG(in.s_win + (2 * i + 1) * batch + sig);
        const int32_t wh = ED_LDG(in.k_win + (2 * i) * batch + sig) & 15;
        const int32_t wl = ED_LDG(in.k_win + (2 * i + 1) * batch + sig) & 15;
        t.win[i] = ((s_hi * 16 + s_lo) & 255) | wh << 8 | wl << 12;
      }
    });
  });
  // [m]A = [m-1]A + A, plain T on the p side
  for (int m = 2; m < NTAB; ++m) team_add(step, t, k, t.tab[m], t.tab[m - 1], t.q, true);
  // then every entry's T becomes T*2d, four entries a step: entries are
  // only ever the q operand of team_add (identity's T*2d is 0)
  for (int m0 = 1; m0 < NTAB; m0 += ROLES) {
    step([&](int r) {
      const bool live = m0 + r < NTAB;
      fe_mul(pr, live ? t.tab[m0 + r].c[3] : t.spare[r], live ? t.tab[m0 + r].c[3] : k.d2, k.d2);
    });
  }
  for (int i = 0; i < NSTEPS; ++i) {
    const int32_t code = t.win[i];
    // need_t schedule: only the last doubling of a run and the addition
    // that feeds another addition produce T
    team_double(step, t, k, false, btab + (code & 255) * 4 * NL);
    for (int j = 1; j < 4; ++j) team_double(step, t, k, j == 3, nullptr);
    team_add(step, t, k, t.acc, t.acc, t.tab[(code >> 8) & 15], false);
    for (int j = 0; j < 4; ++j) team_double(step, t, k, j == 3, nullptr);
    team_add(step, t, k, t.acc, t.acc, t.tab[(code >> 12) & 15], true);
    team_add(step, t, k, t.acc, t.acc, t.q, false);
  }
}

// Does acc compress to (r_y, r_sign)?  r_y is the RAW 13-bit split of the
// encoding's low 255 bits (never reduced), so y >= p never matches.  Role
// 0 inverts Z (the table is free scratch by now), roles 0 and 1 take X
// and Y to canonical affine form, role 0 compares and writes *ok.  The
// other roles idle: repeating the inversion on them, to keep the warp
// converged, measured slower on an H100.
template <class Step>
ED_HD void team_compressed_equals(const Step& step, Team& t,
                                  const int32_t* r_y, const int32_t* r_sign,
                                  int32_t* ok) {
  const auto& pr = step.pair;
  int32_t* zinv = t.prod[0];
  step([&](int r) {
    if (r == 0) fe_pow_inv(pr, zinv, t.acc.c[2], t.tab[0].c[0]);
  });
  step([&](int r) {
    if (r < 2) {
      fe_mul(pr, t.lin[r], t.acc.c[r], zinv);
      fe_canonical(pr, t.lin[r]);
    }
  });
  step([&](int r) {
    if (r == 0) {
      pr.lead([&] {
        int32_t eq = (t.lin[0][0] & 1) == ED_LDG(r_sign);
        for (int l = 0; l < NL; ++l) eq &= t.lin[1][l] == ED_LDG(r_y + l);
        *ok = eq;
      });
    }
  });
}

// Role r writes coordinate r of acc to out[r] (rows of [B][NL]).
template <class Step>
ED_HD void team_store(const Step& step, const Team& t, int32_t* ox,
                      int32_t* oy, int32_t* oz, int32_t* ot, int sig) {
  step([&](int r) {
    int32_t* dst = pick(r, ox, oy, oz, ot) + sig * NL;
    step.pair.each([&](int h, int) {
      for (int l = HALF * h; l < HALF * (h + 1); ++l) dst[l] = t.acc.c[r][l];
    });
  });
}

}  // namespace ed25519
