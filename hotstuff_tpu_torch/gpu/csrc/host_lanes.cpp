// Host build of the kernel body: the team schedule of dsm_kernels.cu with
// each step's four roles run one after another, forward or in reverse,
// and each role's pair of halves likewise, signature after signature.
// The CPU tests compile this with g++ into a ctypes library and hold it
// against the plain PyTorch versions and the Pallas kernel, so most
// kernel-math faults, and a step in which one role reads what another
// writes, show up without a card.

#include <stdint.h>
#include <string.h>

#include "ed25519_field.cuh"

using ed25519::Consts;
using ed25519::LaneIn;
using ed25519::NL;
using ed25519::ROLES;
using ed25519::Team;

namespace {

// Both halves of a pair, in one call: each phase of a field operation
// runs for half 0 and half 1 (or 1 and 0) before the next phase.
struct HostPair {
  static constexpr int N = 2;
  bool reverse;
  template <class F>
  void each(F&& f) const {
    for (int i = 0; i < N; ++i) {
      const int h = reverse ? N - 1 - i : i;
      f(h, h);
    }
  }
  template <class F>
  void lead(F&& f) const {
    f();
  }
  void swap(const int32_t* send, int32_t* recv) const {
    recv[0] = send[1];
    recv[1] = send[0];
  }
  void sync() const {}
};

struct HostStep {
  bool reverse;
  HostPair pair;
  template <class F>
  void operator()(F&& f) const {
    for (int i = 0; i < ROLES; ++i) f(reverse ? ROLES - 1 - i : i);
  }
};

Consts make_consts(const int32_t* d2, const int32_t* subpad) {
  Consts k;
  memset(&k, 0, sizeof k);
  for (int l = 0; l < NL; ++l) {
    k.d2[l] = d2[l];
    k.subpad[l] = subpad[l];
  }
  return k;
}

LaneIn lane_in(const int32_t* ax, const int32_t* ay, const int32_t* az,
               const int32_t* at, const int32_t* s_win, const int32_t* k_win) {
  LaneIn in;
  in.ax = ax;
  in.ay = ay;
  in.az = az;
  in.at = at;
  in.s_win = s_win;
  in.k_win = k_win;
  return in;
}

// A team filled with a pattern that no step may read before writing:
// shared memory is not zeroed on the card either.
void scrub(Team& t) { memset(&t, 0x5a, sizeof t); }

}  // namespace

extern "C" void host_dsm_verify(const int32_t* btab, const int32_t* d2,
                                const int32_t* subpad, const int32_t* ax,
                                const int32_t* ay, const int32_t* az,
                                const int32_t* at, const int32_t* s_win,
                                const int32_t* k_win, const int32_t* r_y,
                                const int32_t* r_sign, int32_t* ok, int batch,
                                int reverse) {
  const Consts k = make_consts(d2, subpad);
  const LaneIn in = lane_in(ax, ay, az, at, s_win, k_win);
  const HostStep step{reverse != 0, HostPair{reverse != 0}};
  Team t;
  for (int sig = 0; sig < batch; ++sig) {
    scrub(t);
    ed25519::team_scan(step, t, k, btab, in, sig, batch);
    ed25519::team_compressed_equals(step, t, r_y + sig * NL, r_sign + sig,
                                    ok + sig);
  }
}

extern "C" void host_dsm_scan(const int32_t* btab, const int32_t* d2,
                              const int32_t* subpad, const int32_t* ax,
                              const int32_t* ay, const int32_t* az,
                              const int32_t* at, const int32_t* s_win,
                              const int32_t* k_win, int32_t* ox, int32_t* oy,
                              int32_t* oz, int32_t* ot, int batch,
                              int reverse) {
  const Consts k = make_consts(d2, subpad);
  const LaneIn in = lane_in(ax, ay, az, at, s_win, k_win);
  const HostStep step{reverse != 0, HostPair{reverse != 0}};
  Team t;
  for (int sig = 0; sig < batch; ++sig) {
    scrub(t);
    ed25519::team_scan(step, t, k, btab, in, sig, batch);
    ed25519::team_store(step, t, ox, oy, oz, ot, sig);
  }
}

// out[i] = a[i] * b[i] and out[i] = a[i]^2 over n elements of NL limbs.
extern "C" void host_fe_mul(int32_t* out, const int32_t* a, const int32_t* b,
                            int n) {
  const HostPair pr{false};
  for (int i = 0; i < n; ++i) ed25519::fe_mul(pr, out + i * NL, a + i * NL, b + i * NL);
}

extern "C" void host_fe_sqr(int32_t* out, const int32_t* a, int n) {
  const HostPair pr{false};
  for (int i = 0; i < n; ++i) ed25519::fe_sqr(pr, out + i * NL, a + i * NL);
}
