// Hopper (sm_90a) kernels of the fused Ed25519 double-scalar verifier.
//
//   dsm_verify_kernel  replaces hotstuff_tpu/tpu/pallas_dsm.py
//                      verify_compressed (_dsm_verify_kernel): the
//                      32-step Straus scan P = [s]B + [k](-A) and the
//                      on-chip check that P compresses to R.
//   dsm_scan_kernel    replaces pallas_dsm.dual_scalar_mult (_dsm_kernel):
//                      the same scan, writing X, Y, Z (T = 0).
//
// Bound on an H100: operations.  A verify is 2955 field multiplies, 1278
// of them squarings: 939,180 int32 multiply-adds per signature (400 per
// product, 210 per square), against ~1.3 KB of operands.  But a
// signature is one chain of dependent point operations, and at the
// production batch of 1024 there are too few signatures to fill the
// card: what bounds the time is the length of one warp's instruction
// stream (an int32 warp instruction issues in 2 cycles on a 16-lane
// pipe), not the total work.
//
// Design: a team of eight threads per signature (ed25519_field.cuh).  The
// point formulas are Hisil-Wong-Carter-Dawson's four-processor waves, as
// the Pallas kernel batches them; role r computes the r-th product of
// each wave, which cuts the scan's critical path from 2688 multiplies to
// ~740 wave steps.  Each role is a pair of threads that splits every
// field operation by limbs (a shuffle per carry pass), which halves each
// product's multiply-adds per thread.  One warp per block (4 signatures)
// spreads the teams over the SMs; the whole warp runs one schedule, with
// __syncwarp() between steps.  Each team's accumulator, [0..15]A table
// and exchange slots live in dynamic shared memory (8.4 KB a team), in
// 16-byte-aligned slots of 24 limbs.  The 80 KB base table stays in
// global memory (read through __ldg, one coordinate per role).  The
// epilogue's inversion runs on role 0.  The CPU tests run the same
// schedule on the host with each step's roles forward and in reverse,
// which catches a missing barrier.
//
// Each launcher takes every pointer and the stream as void*, launches on
// that stream with the tensors' device current (the caller's device is
// current again on return), does not synchronise, and returns
// cudaGetLastError().  The batch must be a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_field.cuh"

namespace {

using ed25519::Consts;
using ed25519::LaneIn;
using ed25519::NL;
using ed25519::ROLES;
using ed25519::Team;

constexpr int kThreads = 32;                      // one warp per block
constexpr int kTeamThreads = 2 * ROLES;           // a pair per role
constexpr int kTeams = kThreads / kTeamThreads;   // signatures per block
constexpr int kSmemBytes = sizeof(Consts) + kTeams * sizeof(Team);
static_assert(kSmemBytes <= 48 * 1024, "above 48 KB a launch needs cudaFuncSetAttribute");

// This thread as one half of its pair (lanes 2m and 2m + 1).
struct WarpPair {
  static constexpr int N = 1;
  int h;
  unsigned mask;
  template <class F>
  __host__ __device__ void each(F&& f) const {
    f(h, 0);
  }
  template <class F>
  __host__ __device__ void lead(F&& f) const {
    if (h == 0) f();
  }
  __host__ __device__ void swap(const int32_t* send, int32_t* recv) const {
#if defined(__CUDA_ARCH__)
    recv[0] = __shfl_xor_sync(mask, send[0], 1);
#endif
  }
  __host__ __device__ void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp(mask);
#endif
  }
};

// Runs a step: each thread its own role, then the warp's barrier.
struct WarpStep {
  int role;
  WarpPair pair;
  template <class F>
  __host__ __device__ void operator()(F&& f) const {
    f(role);
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};

__device__ WarpStep warp_step() {
  const int lane = threadIdx.x % kThreads;
  return WarpStep{(lane / 2) % ROLES, WarpPair{lane % 2, 3u << (lane & ~1)}};
}

// This block's constants and this thread's team, in dynamic shared memory.
__device__ Team& block_team(const int32_t* d2, const int32_t* subpad,
                            Consts*& k) {
  extern __shared__ int4 smem[];
  k = reinterpret_cast<Consts*>(smem);
  for (int l = threadIdx.x; l < NL; l += blockDim.x) {
    k->d2[l] = d2[l];
    k->subpad[l] = subpad[l];
  }
  __syncthreads();
  Team* teams = reinterpret_cast<Team*>(smem + sizeof(Consts) / sizeof(int4));
  return teams[threadIdx.x / kTeamThreads];
}

__global__ void __launch_bounds__(kThreads)
    dsm_verify_kernel(const int32_t* btab, const int32_t* d2,
                      const int32_t* subpad, LaneIn in, const int32_t* r_y,
                      const int32_t* r_sign, int32_t* ok, int batch) {
  Consts* k;
  Team& t = block_team(d2, subpad, k);
  const int sig = (blockIdx.x * blockDim.x + threadIdx.x) / kTeamThreads;
  const WarpStep step = warp_step();
  ed25519::team_scan(step, t, *k, btab, in, sig, batch);
  ed25519::team_compressed_equals(step, t, r_y + sig * NL, r_sign + sig,
                                  ok + sig);
}

__global__ void __launch_bounds__(kThreads)
    dsm_scan_kernel(const int32_t* btab, const int32_t* d2,
                    const int32_t* subpad, LaneIn in, int32_t* ox, int32_t* oy,
                    int32_t* oz, int32_t* ot, int batch) {
  Consts* k;
  Team& t = block_team(d2, subpad, k);
  const int sig = (blockIdx.x * blockDim.x + threadIdx.x) / kTeamThreads;
  const WarpStep step = warp_step();
  ed25519::team_scan(step, t, *k, btab, in, sig, batch);
  ed25519::team_store(step, t, ox, oy, oz, ot, sig);
}

LaneIn lane_in(void* ax, void* ay, void* az, void* at, void* s_win,
               void* k_win) {
  LaneIn in;
  in.ax = static_cast<const int32_t*>(ax);
  in.ay = static_cast<const int32_t*>(ay);
  in.az = static_cast<const int32_t*>(az);
  in.at = static_cast<const int32_t*>(at);
  in.s_win = static_cast<const int32_t*>(s_win);
  in.k_win = static_cast<const int32_t*>(k_win);
  return in;
}

int blocks_for(int batch) { return batch / kTeams; }

// Runs `launch` with `device` current and then makes the caller's device
// current again, so a launcher never changes the calling thread's device.
// Returns `launch`'s error, else the restore's.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int dsm_verify_launch(void* btab, void* d2, void* subpad, void* ax,
                                 void* ay, void* az, void* at, void* s_win,
                                 void* k_win, void* r_y, void* r_sign,
                                 void* ok, int batch, int device,
                                 void* stream) {
  if (batch <= 0 || batch % kTeams) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    dsm_verify_kernel<<<blocks_for(batch), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(btab), static_cast<const int32_t*>(d2),
        static_cast<const int32_t*>(subpad),
        lane_in(ax, ay, az, at, s_win, k_win), static_cast<const int32_t*>(r_y),
        static_cast<const int32_t*>(r_sign), static_cast<int32_t*>(ok), batch);
    return cudaGetLastError();
  });
}

extern "C" int dsm_scan_launch(void* btab, void* d2, void* subpad, void* ax,
                               void* ay, void* az, void* at, void* s_win,
                               void* k_win, void* ox, void* oy, void* oz,
                               void* ot, int batch, int device,
                               void* stream) {
  if (batch <= 0 || batch % kTeams) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    dsm_scan_kernel<<<blocks_for(batch), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(btab), static_cast<const int32_t*>(d2),
        static_cast<const int32_t*>(subpad),
        lane_in(ax, ay, az, at, s_win, k_win), static_cast<int32_t*>(ox),
        static_cast<int32_t*>(oy), static_cast<int32_t*>(oz),
        static_cast<int32_t*>(ot), batch);
    return cudaGetLastError();
  });
}

// Dynamic shared memory of one block of either kernel, in bytes.
extern "C" int dsm_smem_bytes() { return kSmemBytes; }

extern "C" const char* dsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
