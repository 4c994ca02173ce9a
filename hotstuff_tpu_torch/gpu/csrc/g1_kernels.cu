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
// Bound on an H100: operations.  A point addition is 12 Fq products of
// 12x12 32-bit words (2 x 144 multiply-adds each in CIOS), ~3,500 int32
// multiply-adds; operands are a few hundred bytes a point.  Each call is
// a chain of dependent point additions (a tree level after level; the
// running sum one addition; the ladder 2 x nbits), so its time is the
// length of one thread's instruction stream, not the work over the card.
//
// Design (simple first): the field is canonical 12-word Montgomery
// arithmetic (g1_field.cuh); one thread per point addition.  The tree runs
// in ONE block of 256 threads that walks the levels over a scratch buffer
// in global memory (the wrapper allocates it), with __syncthreads()
// between levels.  The running sum is one thread; the new point comes by
// value in the launch's parameters, so a vote costs no host-to-device
// copy.  The ladder is one thread a lane, 32 lanes a block so the lanes
// spread over the SMs.
//
// Each launcher takes every pointer and the stream as void*, launches on
// that stream with the tensors' device current (the caller's device is
// current again on return), does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "g1_field.cuh"

namespace {

constexpr int kTreeThreads = 256;
constexpr int kLadderThreads = 32;

// The block as a team for aggregate_tree: a level's pairs strided over
// the block's threads, __syncthreads() between levels.
struct BlockTeam {
  template <class F>
  __host__ __device__ void each(int n, F&& f) const {
#if defined(__CUDA_ARCH__)
    for (int i = threadIdx.x; i < n; i += blockDim.x) f(i);
#endif
  }
  __host__ __device__ void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

__global__ void __launch_bounds__(kTreeThreads)
    g1_aggregate_kernel(const int32_t* xs, const int32_t* ys,
                        const int32_t* zs, int batch, int plain,
                        g1::Point* scratch, int32_t* ox, int32_t* oy,
                        int32_t* oz) {
  g1::aggregate_tree(BlockTeam{}, xs, ys, zs, batch, plain, scratch, ox, oy, oz);
}

__global__ void __launch_bounds__(32)
    g1_running_add_kernel(int32_t* acc, g1::Affine p) {
  if (threadIdx.x == 0) g1::running_add(acc, p);
}

__global__ void __launch_bounds__(kLadderThreads)
    g1_scalar_mult_kernel(const int32_t* bits, int nbits, int batch,
                          const int32_t* xs, const int32_t* ys,
                          const int32_t* zs, int32_t* ox, int32_t* oy,
                          int32_t* oz) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < batch)
    g1::scalar_mult_lane(bits, nbits, batch, lane, xs, ys, zs, ox, oy, oz);
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

// scratch: batch / 2 points (36 words each), at least one.
extern "C" int g1_aggregate_launch(void* xs, void* ys, void* zs, int batch,
                                   int plain, void* scratch, void* ox,
                                   void* oy, void* oz, int device,
                                   void* stream) {
  if (!power_of_two(batch)) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    g1_aggregate_kernel<<<1, kTreeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(xs), static_cast<const int32_t*>(ys),
        static_cast<const int32_t*>(zs), batch, plain,
        static_cast<g1::Point*>(scratch), static_cast<int32_t*>(ox),
        static_cast<int32_t*>(oy), static_cast<int32_t*>(oz));
    return cudaGetLastError();
  });
}

// acc: 3 x 30 int32 (X, Y, Z rows), updated in place; p by value.
extern "C" int g1_running_add_launch(void* acc, g1::Affine p, int device,
                                     void* stream) {
  return on_device(device, [&] {
    g1_running_add_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(acc), p);
    return cudaGetLastError();
  });
}

extern "C" int g1_scalar_mult_launch(void* bits, int nbits, int batch,
                                     void* xs, void* ys, void* zs, void* ox,
                                     void* oy, void* oz, int device,
                                     void* stream) {
  if (batch <= 0 || nbits < 0) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    const int blocks = (batch + kLadderThreads - 1) / kLadderThreads;
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
