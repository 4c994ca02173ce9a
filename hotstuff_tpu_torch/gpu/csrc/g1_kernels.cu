// Hopper (sm_90a) kernels of the BLS12-381 G1 device path.
//
//   g1_aggregate_kernel     replaces hotstuff_tpu/tpu/bls.py
//                           _aggregate_impl / _aggregate_plain_impl
//                           (:255-287): the tree sum of a power-of-two
//                           batch of projective points to one.
//   g1_running_add_kernel   replaces _running_add_impl + _freshen
//                           (:468-490, :566): acc <- acc + P, one vote a
//                           launch.
//   g1_scalar_mult_kernel   replaces _scalar_mult_kernel (:579-601): the
//                           batched MSB-first double-and-add [k_i]P_i.
//
// The JAX functions are XLA programs, one dispatch a call; in eager
// PyTorch their plain versions launch one small kernel an operation (a
// point addition is ~4,600), so each becomes one hand kernel, one launch
// a call.
//
// What bounds them on an H100: a chain of dependent products, not
// operations or bytes.  A point addition is 12 Fq products of 12x12
// 32-bit words (2 x 144 multiply-adds each in CIOS, ~3,500 int32
// multiply-adds an addition), and its operands are a few hundred bytes.
// Each call is a chain of dependent point additions (a tree level after
// level; the running sum one addition; the ladder 2 x nbits), and a CIOS
// product is itself a chain of dependent multiply-adds and carries, so
// one thread's time is ~the latency of its instruction stream: with one
// thread an addition, the twelve products run one after another, while
// the card's int32 rate would do the whole call's work in well under a
// millisecond.
//
// Design: a point addition is the work of a team of six threads
// (g1_field.cuh team_point_add): Algorithm 7's products fall into two
// stages of six independent ones, one a member, so the chain is two
// products (plus additions) instead of twelve.  A team is 8 lanes of a
// warp (six members, two idle), so four teams share a warp; members
// exchange stage outputs through the team's slots in shared memory, with
// __syncwarp over the team's six lanes between stages, and run the same
// instructions on operands chosen by index, so a warp does not diverge.
// The row conversions at the edges are split over the members too (one
// coordinate each).
//
//   tree     blocks of 16 teams (128 threads): block g of G sums the
//            leaves g, g + G, g + 2G, ... (in JAX's order a subtree, so
//            the sum is the same), one pair a team at the first level,
//            whose six row conversions are one a member; the levels run
//            with __syncthreads() between them over the block's region of
//            a scratch buffer in device memory (the wrapper allocates it;
//            L2 holds it).  The last block to finish (an atomic count,
//            zeroed by the launcher) sums the G partials.  Spreading the
//            leaves over blocks keeps each SM's warps few, so a level is
//            bound by the latency of one team addition, not by one SM's
//            issue rate: B = 1024 is 32 blocks and 10 rounds of a team
//            addition.
//   running  one team in an 8-thread block (team_running_add): a stage
//   sum      of six conversions (the accumulator's three rows, the
//            point's x, y and 1, one a member), the team addition's two
//            stages, a stage of three row stores; a chain of about five
//            products where one thread ran about twenty.  The new point
//            comes by value in the launch's parameters, so a vote costs
//            no host-to-device copy.
//   ladder   one team a lane, 8 teams a block, so the storm's 1024 lanes
//            are 128 blocks, one on each of 128 SMs; the accumulator and
//            P live in the team's slots, and the teams past the batch
//            leave at once.  Every doubling and add runs, the add's
//            result taken where the bit is set, as in JAX.

// Each launcher takes every pointer and the stream as void*, launches on
// that stream with the tensors' device current (the caller's device is
// current again on return), does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "g1_field.cuh"

namespace {

constexpr int kTeamLanes = 8;  // a team's lanes: its six members, two idle
constexpr int kTreeThreads = g1::kTreeTeams * kTeamLanes;
constexpr int kLadderTeams = 8;
constexpr int kLadderThreads = kLadderTeams * kTeamLanes;

// This thread's team: its member index (6 and 7 idle), the six members'
// lanes of its warp, and its slots.  stage() runs f on this thread's
// member and then the team's barrier; idle lanes do neither.
struct WarpTeam {
  int member;
  unsigned mask;
  g1::TeamSlots* sl;
  template <class F>
  __host__ __device__ void stage(int n, F&& f) const {
#if defined(__CUDA_ARCH__)
    if (member < g1::kMembers) {
      if (member < n) f(member);
      __syncwarp(mask);
    }
#endif
  }
  __host__ __device__ g1::TeamSlots& slots() const { return *sl; }
};

__device__ WarpTeam this_team(g1::TeamSlots* block_slots) {
  const int t = threadIdx.x / kTeamLanes;
  const unsigned first = (threadIdx.x % 32u) & ~(unsigned)(kTeamLanes - 1);
  return WarpTeam{(int)(threadIdx.x % kTeamLanes), 0x3fu << first, block_slots + t};
}

// The block's teams for aggregate_tree: a level's pairs strided over the
// teams, __syncthreads() between levels.
struct BlockTeams {
  WarpTeam team;
  int index;
  template <class F>
  __host__ __device__ void each(int n, F&& f) const {
#if defined(__CUDA_ARCH__)
    for (int i = index; i < n; i += g1::kTreeTeams) f(team, i);
#endif
  }
  __host__ __device__ void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

// scratch: batch / 2 points; arrived: the blocks that finished, 0 at the
// launch.
__global__ void __launch_bounds__(kTreeThreads)
    g1_aggregate_kernel(const int32_t* xs, const int32_t* ys,
                        const int32_t* zs, int batch, int plain,
                        g1::Fe* scratch, unsigned* arrived, int32_t* ox,
                        int32_t* oy, int32_t* oz) {
  __shared__ g1::TeamSlots slots[g1::kTreeTeams];
  __shared__ bool last;
  const BlockTeams teams{this_team(slots), (int)(threadIdx.x / kTeamLanes)};
  if (batch == 1) {
    g1::tree_one(teams, xs, ys, zs, plain, ox, oy, oz);
    return;
  }
  const int blocks = gridDim.x;
  g1::tree_block(teams, blockIdx.x, blocks, xs, ys, zs, batch, plain, scratch);
  __threadfence();  // this block's partial, before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrived, 1u) == (unsigned)blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  g1::tree_final(teams, blocks, batch / blocks, scratch, ox, oy, oz);
}

// One team: lanes 0-5 its members (mask 0x3f), 6-7 idle.
__global__ void __launch_bounds__(kTeamLanes)
    g1_running_add_kernel(int32_t* acc, const __grid_constant__ g1::Affine p) {
  __shared__ g1::TeamSlots slots;
  g1::team_running_add(this_team(&slots), acc, p);
}

__global__ void __launch_bounds__(kLadderThreads)
    g1_scalar_mult_kernel(const int32_t* bits, int nbits, int batch,
                          const int32_t* xs, const int32_t* ys,
                          const int32_t* zs, int32_t* ox, int32_t* oy,
                          int32_t* oz) {
  __shared__ g1::TeamSlots slots[kLadderTeams];
  const int lane = blockIdx.x * kLadderTeams + threadIdx.x / kTeamLanes;
  if (threadIdx.x % kTeamLanes >= g1::kMembers || lane >= batch) return;
  g1::scalar_mult_lane(this_team(slots), bits, nbits, batch, lane, xs, ys, zs,
                       ox, oy, oz);
}

// Runs `launch` with `device` current and then makes the caller's device
// current again.  Returns `launch`'s error, else the restore's.
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

bool power_of_two(int n) { return n > 0 && (n & (n - 1)) == 0; }

}  // namespace

// scratch: batch / 2 + 1 points (36 words each); the last one's first
// word counts the blocks that finished.
extern "C" int g1_aggregate_launch(void* xs, void* ys, void* zs, int batch,
                                   int plain, void* scratch, void* ox,
                                   void* oy, void* oz, int device,
                                   void* stream) {
  if (!power_of_two(batch)) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    const auto s = static_cast<cudaStream_t>(stream);
    g1::Fe* points = static_cast<g1::Fe*>(scratch);
    unsigned* arrived = reinterpret_cast<unsigned*>(points + 3 * (batch / 2));
    const cudaError_t zeroed = cudaMemsetAsync(arrived, 0, sizeof(unsigned), s);
    if (zeroed != cudaSuccess) return zeroed;
    g1_aggregate_kernel<<<g1::tree_blocks(batch), kTreeThreads, 0, s>>>(
        static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
        static_cast<const int32_t*>(zs), batch, plain, points, arrived,
        static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
        static_cast<int32_t*>(oz));
    return cudaGetLastError();
  });
}

// acc: 3 x 30 int32 (X, Y, Z rows), updated in place; p by value.
extern "C" int g1_running_add_launch(void* acc, g1::Affine p, int device,
                                     void* stream) {
  return on_device(device, [&] {
    g1_running_add_kernel<<<1, kTeamLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(acc), p);
    return cudaGetLastError();
  });
}

// bits: nbits x batch int32 (MSB first); points and outputs batch rows.
extern "C" int g1_scalar_mult_launch(void* bits, int nbits, int batch,
                                     void* xs, void* ys, void* zs, void* ox,
                                     void* oy, void* oz, int device,
                                     void* stream) {
  if (batch <= 0 || nbits < 0) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    const int blocks = (batch + kLadderTeams - 1) / kLadderTeams;
    g1_scalar_mult_kernel<<<blocks, kLadderThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bits), nbits, batch,
        static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
        static_cast<const int32_t*>(zs), static_cast<int32_t*>(ox),
        static_cast<int32_t*>(oy), static_cast<int32_t*>(oz));
    return cudaGetLastError();
  });
}

extern "C" const char* g1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
