// Fused last-microstep SGD + D2D consensus mixing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_consensus_sgd.py::fused_consensus_sgd. For N stacked
// clusters of s replicas it computes, column by column,
//
//     w'[n]  = w[n] - eta * (g[n] + wd * w[n])       (f32)
//     out[n] = W[n] @ w'[n]                          (f32, one write in w's type)
//
// w, g, out: (N, s, M) f32 or bf16; W: (N, s, s) f32 (the fused_power
// backend's W = V^Gamma); eta: one f32 in device memory (read by every block,
// so the learning rate never crosses to the host); wd: the static weight
// decay (0 skips the term, as the TPU kernel does).
//
// Bound: one read of w, one read of g and one write of out. At the scale-mode
// main path, (2, 2, 464,118,784) f32, that is 22.3 GB, or 6.65 ms at an H100
// SXM's 3.35 TB/s; the arithmetic (2 + 2s FLOPs per element) is far below the
// card's balance point. The TPU kernel's (N, M/4096) grid and its MXU dot are
// not carried over: an (s, s) matrix with s = 2..16 is far below a tensor-core
// tile. Each thread owns one column of one cluster: it loads the s values of
// w and of g (neighbouring threads read neighbouring columns, so every load
// and store is coalesced), forms w' in registers, and writes W[n] w' with W[n]
// in shared memory. s is a template parameter (1..16), as in consensus_mix.cu.
// The SGD step rounds as its plain version does (__fmul_rn / __fsub_rn keep
// nvcc from contracting it into an FMA); the mix accumulates with fmaf in
// column order. A ragged M is masked here, not padded in device memory.
// Vector loads, an in-place output and TMA are left for later work.
//
// The same kernel also replaces repro/kernels/fused_sgd.py::fused_sgd:
// kernels/fused_sgd.py launches the S = 1 instance on the flattened tensor,
// (1, 1, numel), with W = [[1]]; fmaf(1, w', 0) = w' exactly, so it computes
// w - eta * (g + wd * w) with the same rounding (bound 3 * bytes(w) / HBM rate).
//
// C interface (loaded with ctypes): fused_consensus_sgd_f32 / _bf16 launch on
// the given stream, allocate nothing, and return cudaGetLastError()
// (cudaErrorInvalidValue for a cluster size above kMaxClusterSize).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// MAX_CLUSTER_SIZE in kernels/fused_consensus_sgd.py
constexpr int kMaxClusterSize = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
fused_consensus_sgd_kernel(const T* __restrict__ w, const T* __restrict__ g,
                           const float* __restrict__ W,
                           const float* __restrict__ eta_ptr, float wd,
                           T* __restrict__ out, int64_t M) {
  __shared__ float mix[S * S];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    mix[i] = W[static_cast<int64_t>(n) * S * S + i];
  }
  const float eta = *eta_ptr;
  __syncthreads();

  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int64_t base = static_cast<int64_t>(n) * S * M + m;

  float wp[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float wv = to_f32(w[base + i * M]);
    float gv = to_f32(g[base + i * M]);
    if (wd != 0.0f) gv = __fadd_rn(gv, __fmul_rn(wd, wv));
    wp[i] = __fsub_rn(wv, __fmul_rn(eta, gv));
  }

#pragma unroll
  for (int i = 0; i < S; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) acc = fmaf(mix[i * S + j], wp[j], acc);
    out[base + i * M] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* w, const void* g, const void* W, const void* eta,
           float wd, void* out, int N, int s, int64_t M, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kThreads - 1) / kThreads),
                  static_cast<unsigned>(N));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  const float* Wp = static_cast<const float*>(W);
  const float* ep = static_cast<const float*>(eta);
  T* op = static_cast<T*>(out);
  switch (s) {
#define FUSED_CONSENSUS_SGD_CASE(S)                                         \
  case S:                                                                   \
    fused_consensus_sgd_kernel<S, T><<<grid, kThreads, 0, st>>>(            \
        wp, gp, Wp, ep, wd, op, M);                                         \
    break;
    FUSED_CONSENSUS_SGD_CASE(1)
    FUSED_CONSENSUS_SGD_CASE(2)
    FUSED_CONSENSUS_SGD_CASE(3)
    FUSED_CONSENSUS_SGD_CASE(4)
    FUSED_CONSENSUS_SGD_CASE(5)
    FUSED_CONSENSUS_SGD_CASE(6)
    FUSED_CONSENSUS_SGD_CASE(7)
    FUSED_CONSENSUS_SGD_CASE(8)
    FUSED_CONSENSUS_SGD_CASE(9)
    FUSED_CONSENSUS_SGD_CASE(10)
    FUSED_CONSENSUS_SGD_CASE(11)
    FUSED_CONSENSUS_SGD_CASE(12)
    FUSED_CONSENSUS_SGD_CASE(13)
    FUSED_CONSENSUS_SGD_CASE(14)
    FUSED_CONSENSUS_SGD_CASE(15)
    FUSED_CONSENSUS_SGD_CASE(16)
#undef FUSED_CONSENSUS_SGD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxClusterSize == 16, "the switch above covers 1..16");
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_consensus_sgd_f32(const void* w, const void* g,
                                       const void* W, const void* eta,
                                       float wd, void* out, int N, int s,
                                       long long M, void* stream) {
  return launch<float>(w, g, W, eta, wd, out, N, s, M, stream);
}

extern "C" int fused_consensus_sgd_bf16(const void* w, const void* g,
                                        const void* W, const void* eta,
                                        float wd, void* out, int N, int s,
                                        long long M, void* stream) {
  return launch<__nv_bfloat16>(w, g, W, eta, wd, out, N, s, M, stream);
}
