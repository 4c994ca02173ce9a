// Host build of the G1 kernels' bodies (g1_field.cuh).  The CPU tests
// compile this with g++ into a ctypes library and hold it against the
// plain PyTorch versions, the JAX functions and the arbitrary-precision
// oracle, so the kernels' arithmetic is checked without a card.
//
// Two kinds of body:
//   * the kernels' own (host_g1_team_*): the team addition, tree,
//     running sum and ladder of g1_field.cuh, with a HostTeam that runs
//     the six members of each stage one after another, forward or
//     reversed;
//   * the single-thread references (host_g1_aggregate, host_g1_running_add,
//     host_g1_scalar_mult): the same formulas with point_add on one
//     thread, the bodies the kernels had before they were split over
//     teams.

#include <stdint.h>
#include <string.h>

#include <vector>

#include "g1_field.cuh"

namespace {

// A team on one thread: each stage's members in turn (forward or
// reversed); a stage is over when its loop ends, so no barrier is needed.
struct HostTeam {
  bool reverse;
  g1::TeamSlots* sl;
  template <class F>
  void stage(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(reverse ? n - 1 - i : i);
  }
  g1::TeamSlots& slots() const { return *sl; }
};

// The tree's pairs one after another on one team, forward or reversed.
struct HostTeams {
  HostTeam team;
  template <class F>
  void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(team, team.reverse ? n - 1 - i : i);
  }
  void sync() const {}
};

// Slots filled with garbage, as shared memory is on the card.
g1::TeamSlots dirty_slots() {
  g1::TeamSlots sl;
  memset(&sl, 0x5a, sizeof sl);
  return sl;
}

// ---- the single-thread references --------------------------------------------

g1::Point load_point(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                     int i, const g1::Fe& k) {
  g1::Point p;
  p.x = g1::row_to_fe(xs + i * g1::NLIMBS, k);
  p.y = g1::row_to_fe(ys + i * g1::NLIMBS, k);
  p.z = g1::row_to_fe(zs + i * g1::NLIMBS, k);
  return p;
}

void store_point(const g1::Point& p, int32_t* ox, int32_t* oy, int32_t* oz,
                 int i) {
  g1::fe_to_row(p.x, ox + i * g1::NLIMBS);
  g1::fe_to_row(p.y, oy + i * g1::NLIMBS);
  g1::fe_to_row(p.z, oz + i * g1::NLIMBS);
}

void aggregate_one_thread(const int32_t* xs, const int32_t* ys,
                          const int32_t* zs, int batch, int plain,
                          int32_t* ox, int32_t* oy, int32_t* oz, bool reverse) {
  const g1::Fe k_mont = {{G1_K_MONT_IN}};
  const g1::Fe k_plain = {{G1_K_PLAIN_IN}};
  const g1::Fe k = plain ? k_plain : k_mont;
  auto each = [&](int n, auto&& f) {
    for (int i = 0; i < n; ++i) f(reverse ? n - 1 - i : i);
  };
  if (batch == 1) {
    store_point(load_point(xs, ys, zs, 0, k), ox, oy, oz, 0);
    return;
  }
  int half = batch / 2;
  std::vector<g1::Point> scratch(half);
  each(half, [&](int i) {
    scratch[i] = g1::point_add(load_point(xs, ys, zs, i, k),
                               load_point(xs, ys, zs, i + half, k));
  });
  for (half /= 2; half >= 1; half /= 2)
    each(half, [&](int i) { scratch[i] = g1::point_add(scratch[i], scratch[i + half]); });
  store_point(scratch[0], ox, oy, oz, 0);
}

void scalar_mult_one_thread(const int32_t* bits, int nbits, int batch, int lane,
                            const int32_t* xs, const int32_t* ys,
                            const int32_t* zs, int32_t* ox, int32_t* oy,
                            int32_t* oz) {
  const g1::Fe k_mont = {{G1_K_MONT_IN}};
  const g1::Point p = load_point(xs, ys, zs, lane, k_mont);
  g1::Point acc{g1::fe_zero(), g1::fe_one(), g1::fe_zero()};
  for (int i = 0; i < nbits; ++i) {
    acc = g1::point_add(acc, acc);
    const g1::Point added = g1::point_add(acc, p);
    if (bits[i * batch + lane] != 0) acc = added;
  }
  store_point(acc, ox, oy, oz, lane);
}

// acc <- acc + (x : y : 1) on one thread (point_add): acc three canonical
// (or loose) 2^390-Montgomery rows, in place; the point plain and canonical.
void running_add_one_thread(int32_t* acc, const g1::Affine& p) {
  const g1::Fe k_mont = {{G1_K_MONT_IN}};
  const g1::Fe r2 = {{G1_R2}};
  const g1::Point a = load_point(acc, acc + g1::NLIMBS, acc + 2 * g1::NLIMBS, 0, k_mont);
  g1::Fe px, py;
  for (int j = 0; j < g1::NW; ++j) {
    px.w[j] = p.x[j];
    py.w[j] = p.y[j];
  }
  const g1::Point b{g1::fe_mul(px, r2), g1::fe_mul(py, r2), g1::fe_one()};
  store_point(g1::point_add(a, b), acc, acc + g1::NLIMBS, acc + 2 * g1::NLIMBS, 0);
}

}  // namespace

// The single-thread tree, each level's pairs forward or in reverse.
extern "C" void host_g1_aggregate(const int32_t* xs, const int32_t* ys,
                                  const int32_t* zs, int batch, int plain,
                                  int32_t* ox, int32_t* oy, int32_t* oz,
                                  int reverse) {
  aggregate_one_thread(xs, ys, zs, batch, plain, ox, oy, oz, reverse != 0);
}

// acc: 3 x 30 int32 rows, in place; px, py: 12 words each.
extern "C" void host_g1_running_add(int32_t* acc, const uint32_t* px,
                                    const uint32_t* py) {
  g1::Affine p;
  memcpy(p.x, px, sizeof p.x);
  memcpy(p.y, py, sizeof p.y);
  running_add_one_thread(acc, p);
}

// The kernel's running sum on one team (members forward or reversed):
// acc: 3 x 30 int32 rows, in place; px, py: 12 words each.
extern "C" void host_g1_team_running_add(int32_t* acc, const uint32_t* px,
                                         const uint32_t* py, int reverse) {
  g1::Affine p;
  memcpy(p.x, px, sizeof p.x);
  memcpy(p.y, py, sizeof p.y);
  g1::TeamSlots sl = dirty_slots();
  g1::team_running_add(HostTeam{reverse != 0, &sl}, acc, p);
}

// The single-thread ladder, lane after lane.
extern "C" void host_g1_scalar_mult(const int32_t* bits, int nbits, int batch,
                                    const int32_t* xs, const int32_t* ys,
                                    const int32_t* zs, int32_t* ox,
                                    int32_t* oy, int32_t* oz) {
  for (int lane = 0; lane < batch; ++lane)
    scalar_mult_one_thread(bits, nbits, batch, lane, xs, ys, zs, ox, oy, oz);
}

// n additions p[i] + q[i] of points in this header's form (36 words: X,
// Y, Z), into out: mode 0 point_add on one thread, 1 the team with its
// members forward, 2 reversed.  With alias, q is ignored and each p[i] is
// added to itself in place in out (p1, p2 and out one buffer, as the
// ladder's doubling runs).
extern "C" void host_g1_point_add(const uint32_t* p, const uint32_t* q, int n,
                                  int mode, int alias, uint32_t* out) {
  constexpr int kWords = 3 * g1::NW;
  for (int i = 0; i < n; ++i) {
    g1::Fe a[3], b[3];
    memcpy(a, p + i * kWords, sizeof a);
    memcpy(b, (alias ? p : q) + i * kWords, sizeof b);
    if (mode == 0) {
      const g1::Point r = g1::point_add(g1::Point{a[0], a[1], a[2]}, g1::Point{b[0], b[1], b[2]});
      memcpy(out + i * kWords, &r, sizeof r);
      continue;
    }
    g1::TeamSlots sl = dirty_slots();
    const HostTeam team{mode == 2, &sl};
    if (alias) {
      g1::team_point_add(team, a, a, a, true);
      memcpy(out + i * kWords, a, sizeof a);
    } else {
      g1::Fe r[3];
      memset(r, 0x5a, sizeof r);
      g1::team_point_add(team, a, b, r, true);
      memcpy(out + i * kWords, r, sizeof r);
    }
  }
}

// The kernel's tree on one team: its blocks one after another (forward
// or reversed), then the last part; each level's pairs and each stage's
// members forward or in reverse.
extern "C" void host_g1_team_aggregate(const int32_t* xs, const int32_t* ys,
                                       const int32_t* zs, int batch, int plain,
                                       int32_t* ox, int32_t* oy, int32_t* oz,
                                       int reverse) {
  g1::TeamSlots sl = dirty_slots();
  const HostTeams teams{HostTeam{reverse != 0, &sl}};
  if (batch == 1) {
    g1::tree_one(teams, xs, ys, zs, plain, ox, oy, oz);
    return;
  }
  std::vector<g1::Fe> scratch(3 * (batch / 2));
  memset(scratch.data(), 0x5a, scratch.size() * sizeof(g1::Fe));
  const int G = g1::tree_blocks(batch);
  for (int i = 0; i < G; ++i)
    g1::tree_block(teams, reverse ? G - 1 - i : i, G, xs, ys, zs, batch, plain, scratch.data());
  g1::tree_final(teams, G, batch / G, scratch.data(), ox, oy, oz);
}

// The kernel's ladder, lane after lane on one team (members forward or
// reversed).
extern "C" void host_g1_team_scalar_mult(const int32_t* bits, int nbits,
                                         int batch, const int32_t* xs,
                                         const int32_t* ys, const int32_t* zs,
                                         int32_t* ox, int32_t* oy, int32_t* oz,
                                         int reverse) {
  for (int lane = 0; lane < batch; ++lane) {
    g1::TeamSlots sl = dirty_slots();
    g1::scalar_mult_lane(HostTeam{reverse != 0, &sl}, bits, nbits, batch, lane,
                         xs, ys, zs, ox, oy, oz);
  }
}

// out[i] = a[i] * b[i] * 2^-384 mod q over n elements of 12 words.
extern "C" void host_g1_fe_mul(uint32_t* out, const uint32_t* a,
                               const uint32_t* b, int n) {
  for (int i = 0; i < n; ++i) {
    g1::Fe x, y;
    memcpy(x.w, a + i * g1::NW, sizeof x.w);
    memcpy(y.w, b + i * g1::NW, sizeof y.w);
    const g1::Fe r = g1::fe_mul(x, y);
    memcpy(out + i * g1::NW, r.w, sizeof r.w);
  }
}

// Each row of 30 signed limbs -> this header's form -> a canonical row:
// the identity on values mod q (plain = 0), or x -> x * 2^390 (plain = 1).
extern "C" void host_g1_row_roundtrip(const int32_t* rows, int n, int plain,
                                      int32_t* out) {
  const g1::Fe k_mont = {{G1_K_MONT_IN}};
  const g1::Fe k_plain = {{G1_K_PLAIN_IN}};
  for (int i = 0; i < n; ++i)
    g1::fe_to_row(g1::row_to_fe(rows + i * g1::NLIMBS, plain ? k_plain : k_mont),
                  out + i * g1::NLIMBS);
}
