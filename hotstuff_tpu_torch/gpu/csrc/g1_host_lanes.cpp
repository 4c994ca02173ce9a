// Host build of the G1 kernels' bodies (g1_field.cuh): the tree level by
// level with each level's pairs run forward or in reverse, the running
// sum, and the ladder lane after lane.  The CPU tests compile this with
// g++ into a ctypes library and hold it against the plain PyTorch
// versions, the JAX functions and the arbitrary-precision oracle, so the
// kernels' arithmetic is checked without a card.

#include <stdint.h>
#include <string.h>

#include <vector>

#include "g1_field.cuh"

namespace {

// A level's pairs one after another, forward or in reverse; no barrier
// is needed between levels on one thread.
struct HostTeam {
  bool reverse;
  template <class F>
  void each(int n, F&& f) const {
    for (int i = 0; i < n; ++i) f(reverse ? n - 1 - i : i);
  }
  void sync() const {}
};

}  // namespace

extern "C" void host_g1_aggregate(const int32_t* xs, const int32_t* ys,
                                  const int32_t* zs, int batch, int plain,
                                  int32_t* ox, int32_t* oy, int32_t* oz,
                                  int reverse) {
  std::vector<g1::Point> scratch(batch / 2 > 0 ? batch / 2 : 1);
  memset(scratch.data(), 0x5a, scratch.size() * sizeof(g1::Point));
  g1::aggregate_tree(HostTeam{reverse != 0}, xs, ys, zs, batch, plain,
                     scratch.data(), ox, oy, oz);
}

// acc: 3 x 30 int32 rows, in place; px, py: 12 words each.
extern "C" void host_g1_running_add(int32_t* acc, const uint32_t* px,
                                    const uint32_t* py) {
  g1::Affine p;
  memcpy(p.x, px, sizeof p.x);
  memcpy(p.y, py, sizeof p.y);
  g1::running_add(acc, p);
}

extern "C" void host_g1_scalar_mult(const int32_t* bits, int nbits, int batch,
                                    const int32_t* xs, const int32_t* ys,
                                    const int32_t* zs, int32_t* ox,
                                    int32_t* oy, int32_t* oz) {
  for (int lane = 0; lane < batch; ++lane)
    g1::scalar_mult_lane(bits, nbits, batch, lane, xs, ys, zs, ox, oy, oz);
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
