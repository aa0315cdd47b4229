// Fused Gamma-round D2D consensus mixing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/consensus_mix.py::consensus_mix.
// It computes, for N stacked clusters of s devices,
//
//     out[n] = V[n]^gamma[n] @ z[n]        z, out: (N, s, M);  V: (N, s, s) f32
//
// with every round in f32 and one write in z's dtype (f32 or bf16), as the
// TPU kernel and its oracle repro/kernels/ref.py::consensus_mix_ref do.
// gamma: (N,) int32, one round count per cluster (Remark 1); gamma[n] <= 0
// writes z[n] back unchanged.
//
// Bound: the kernel reads z once and writes out once, whatever gamma is, so
// its least time on an H100 SXM is 2 * bytes(z) / 3.35 TB/s. The arithmetic
// is 2 * s FLOPs per element per round: at s = 5 and gamma = 2, 20 FLOPs per
// 8 bytes moved in f32, far below the card's balance point, and an (s, s)
// matrix with s = 5 is far below one tensor-core tile. So a simple design
// suffices: each block takes one cluster n and a run of kThreads columns,
// loads gamma[n] itself (the TPU's scalar prefetch becomes the block's own
// load), keeps V[n] in shared memory, and each thread holds its column's s
// values in registers for all rounds. Neighbouring threads read neighbouring
// columns, so every load and store is coalesced. A ragged M is masked here,
// not padded in device memory. Vector loads, in-place mixing and CUDA graphs
// around the per-iteration loop are left for later work.
//
// C interface (loaded with ctypes): consensus_mix_f32 / consensus_mix_bf16
// launch on the given stream, allocate nothing, and return cudaGetLastError()
// (cudaErrorInvalidValue for a cluster size above kMaxClusterSize).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClusterSize = 16;  // MAX_CLUSTER_SIZE in kernels/consensus_mix.py

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
consensus_mix_kernel(const T* __restrict__ z, const float* __restrict__ V,
                     const int32_t* __restrict__ gamma, T* __restrict__ out,
                     int64_t M) {
  __shared__ float v[S * S];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    v[i] = V[static_cast<int64_t>(n) * S * S + i];
  }
  const int rounds = gamma[n];
  __syncthreads();

  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int64_t base = static_cast<int64_t>(n) * S * M + m;

  float a[S];
#pragma unroll
  for (int i = 0; i < S; ++i) a[i] = to_f32(z[base + i * M]);

  for (int r = 0; r < rounds; ++r) {
    float b[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j) acc = fmaf(v[i * S + j], a[j], acc);
      b[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) a[i] = b[i];
  }

#pragma unroll
  for (int i = 0; i < S; ++i) out[base + i * M] = from_f32<T>(a[i]);
}

template <typename T>
int launch(const void* z, const void* V, const void* gamma, void* out, int N,
           int s, int64_t M, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kThreads - 1) / kThreads),
                  static_cast<unsigned>(N));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* zp = static_cast<const T*>(z);
  const float* vp = static_cast<const float*>(V);
  const int32_t* gp = static_cast<const int32_t*>(gamma);
  T* op = static_cast<T*>(out);
  switch (s) {
#define CONSENSUS_MIX_CASE(S)                                              \
  case S:                                                                  \
    consensus_mix_kernel<S, T><<<grid, kThreads, 0, st>>>(zp, vp, gp, op, M); \
    break;
    CONSENSUS_MIX_CASE(1)
    CONSENSUS_MIX_CASE(2)
    CONSENSUS_MIX_CASE(3)
    CONSENSUS_MIX_CASE(4)
    CONSENSUS_MIX_CASE(5)
    CONSENSUS_MIX_CASE(6)
    CONSENSUS_MIX_CASE(7)
    CONSENSUS_MIX_CASE(8)
    CONSENSUS_MIX_CASE(9)
    CONSENSUS_MIX_CASE(10)
    CONSENSUS_MIX_CASE(11)
    CONSENSUS_MIX_CASE(12)
    CONSENSUS_MIX_CASE(13)
    CONSENSUS_MIX_CASE(14)
    CONSENSUS_MIX_CASE(15)
    CONSENSUS_MIX_CASE(16)
#undef CONSENSUS_MIX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxClusterSize == 16, "the switch above covers 1..16");
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int consensus_mix_f32(const void* z, const void* V, const void* gamma,
                                 void* out, int N, int s, long long M,
                                 void* stream) {
  return launch<float>(z, V, gamma, out, N, s, M, stream);
}

extern "C" int consensus_mix_bf16(const void* z, const void* V, const void* gamma,
                                  void* out, int N, int s, long long M,
                                  void* stream) {
  return launch<__nv_bfloat16>(z, V, gamma, out, N, s, M, stream);
}
