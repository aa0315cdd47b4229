// Fused SGD kernels for Hopper (sm_90a): the last-microstep SGD + D2D
// consensus mix of the scale path, and the plain SGD update. Both take the
// update from one __device__ function, sgd_update, so the port keeps one SGD
// arithmetic: w - eta * (g + wd * w) in f32, rounded as its plain versions
// round it (__fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting the
// step into an FMA, so the f32 result is bitwise that of fused_sgd_plain).
// eta is one f32 in device memory, so the learning rate never crosses to the
// host; wd is the static weight decay (0 skips the term, as the TPU kernels
// do). Both are bound by device memory: one read of w, one of g and one write
// of out, 3 * bytes(w) over the card's rate.
//
// fused_consensus_sgd_kernel replaces the Pallas TPU kernel
// repro/kernels/fused_consensus_sgd.py::fused_consensus_sgd. For N stacked
// clusters of s replicas it computes, column by column,
//
//     w'[n]  = w[n] - eta * (g[n] + wd * w[n])       (f32)
//     out[n] = W[n] @ w'[n]                          (f32, one write in w's type)
//
// w, g, out: (N, s, M) f32 or bf16; W: (N, s, s) f32 (the fused_power
// backend's W = V^Gamma). At the scale path's main shape, (2, 2, 464,118,784)
// f32, the bound is 22.3 GB, 6.65 ms at an H100 SXM's 3.35 TB/s; the
// arithmetic (2 + 2s FLOPs per element) is far below the card's balance
// point. The TPU kernel's (N, M/4096) grid and its MXU dot are not carried
// over: an (s, s) matrix with s = 2..16 is far below a tensor-core tile. Each
// thread owns one column of one cluster: it loads the s values of w and of g
// (neighbouring threads read neighbouring columns, so every load and store is
// coalesced), forms w' in registers, and writes W[n] w' with W[n] in shared
// memory; the mix accumulates with fmaf in column order. s is a template
// parameter (1..16), as in consensus_mix.cu. A ragged M is masked here, not
// padded in device memory.
//
// fused_sgd_kernel replaces repro/kernels/fused_sgd.py::fused_sgd: the update
// alone over any contiguous array of n elements. It does no arithmetic worth
// counting, so it is a pure stream and must run at the HBM rate:
// - 16-byte loads and stores (a float4, or eight bf16 in a uint4), with the
//   evict-first hints __ldcs / __stcs, since the arrays are far larger than
//   the 50 MB L2;
// - each thread handles kSgdUnroll = 1 vector of w and one of g of a block's
//   contiguous tile, loading both before its store (two vectors of each a
//   thread ran no faster: tools/kernel_ablations.py);
// - a grid-stride loop with 64-bit indices (numel is 1.86e9 at the scale
//   path's flat buffer) over a grid that covers the array, one tile a block
//   (the loop takes what grid.x cannot cover): on the H100 a grid of a few
//   waves of the 132 SMs, each block striding over many tiles, streamed
//   5-6 % slower at the main shape (tools/kernel_ablations.py);
// - eta is read once a thread; no shared memory, no __syncthreads;
// - the elements before the first 16-byte boundary (the head) and after the
//   last whole vector (the tail) take scalar code. When w, g and out do not
//   share one offset mod 16, the whole array takes the scalar loop, in the
//   same kernel.
//
// C interface (loaded with ctypes): each entry launches on the given stream,
// allocates nothing and returns cudaGetLastError(). fused_consensus_sgd_f32 /
// _bf16 return cudaErrorInvalidValue for a cluster size above
// kMaxClusterSize; fused_sgd_f32 / _bf16 take (w, g, eta, wd, out, n).

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

// The one SGD arithmetic of the port: w - eta * (g + wd * w), rounded as
// its plain versions round it.
__device__ __forceinline__ float sgd_update(float w, float g, float eta,
                                            float wd) {
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, w));
  return __fsub_rn(w, __fmul_rn(eta, g));
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
    wp[i] = sgd_update(to_f32(w[base + i * M]), to_f32(g[base + i * M]),
                       eta, wd);
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

// fused_sgd: 16 bytes of T, four f32 or eight bf16, and the update of each
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kCount = 4;
  __device__ static __forceinline__ float4 update(float4 w, float4 g,
                                                  float eta, float wd) {
    return make_float4(sgd_update(w.x, g.x, eta, wd),
                       sgd_update(w.y, g.y, eta, wd),
                       sgd_update(w.z, g.z, eta, wd),
                       sgd_update(w.w, g.w, eta, wd));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static constexpr int kCount = 8;
  // two bf16 in a 32-bit word, the lower one first; bf16 -> f32 is exact
  __device__ static __forceinline__ uint32_t pair(uint32_t w, uint32_t g,
                                                  float eta, float wd) {
    const float lo = sgd_update(__uint_as_float(w << 16),
                                __uint_as_float(g << 16), eta, wd);
    const float hi = sgd_update(__uint_as_float(w & 0xffff0000u),
                                __uint_as_float(g & 0xffff0000u), eta, wd);
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
  }
  __device__ static __forceinline__ uint4 update(uint4 w, uint4 g, float eta,
                                                 float wd) {
    return make_uint4(pair(w.x, g.x, eta, wd), pair(w.y, g.y, eta, wd),
                      pair(w.z, g.z, eta, wd), pair(w.w, g.w, eta, wd));
  }
};

constexpr int kSgdThreads = 128;
constexpr int kSgdUnroll = 1;       // 16-byte vectors of w (and of g) a thread
constexpr int64_t kSgdMaxBlocks = 2147483647;  // grid.x

template <typename T>
__global__ void __launch_bounds__(kSgdThreads)
fused_sgd_kernel(const T* __restrict__ w, const T* __restrict__ g,
                 const float* __restrict__ eta_ptr, float wd,
                 T* __restrict__ out, int64_t n) {
  using V = typename Vec16<T>::type;
  constexpr int kCount = Vec16<T>::kCount;
  const float eta = *eta_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  // the head: the elements before w's first 16-byte boundary, or all of them
  // when w, g and out do not share an offset mod 16
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const bool together = (wa - reinterpret_cast<uintptr_t>(g)) % 16 == 0 &&
                        (wa - reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  int64_t head = together ? static_cast<int64_t>((16 - wa % 16) % 16 /
                                                 sizeof(T))
                          : n;
  head = head < n ? head : n;
  for (int64_t i = tid; i < head; i += stride) {
    out[i] = from_f32<T>(sgd_update(to_f32(w[i]), to_f32(g[i]), eta, wd));
  }

  // whole tiles of kSgdThreads x kSgdUnroll vectors, one contiguous tile a
  // block an iteration (neighbouring threads on neighbouring vectors)
  const int64_t nvec = (n - head) / kCount;
  const V* wv = reinterpret_cast<const V*>(w + head);
  const V* gv = reinterpret_cast<const V*>(g + head);
  V* ov = reinterpret_cast<V*>(out + head);
  constexpr int kTile = kSgdThreads * kSgdUnroll;
  const int64_t tiles = nvec / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * kTile + threadIdx.x;
    V a[kSgdUnroll], b[kSgdUnroll];
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      a[u] = __ldcs(wv + base + u * kSgdThreads);
      b[u] = __ldcs(gv + base + u * kSgdThreads);
    }
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      __stcs(ov + base + u * kSgdThreads,
             Vec16<T>::update(a[u], b[u], eta, wd));
    }
  }
  for (int64_t i = tiles * kTile + tid; i < nvec; i += stride) {
    __stcs(ov + i, Vec16<T>::update(__ldcs(wv + i), __ldcs(gv + i), eta, wd));
  }

  // the tail: after the last whole vector
  for (int64_t e = head + nvec * kCount + tid; e < n; e += stride) {
    out[e] = from_f32<T>(sgd_update(to_f32(w[e]), to_f32(g[e]), eta, wd));
  }
}

template <typename T>
int launch_sgd(const void* w, const void* g, const void* eta, float wd,
               void* out, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // one tile a block: the grid covers the array (a grid of a few waves,
  // each block striding over many tiles, streams 5-6 % slower)
  const int64_t per_block =
      static_cast<int64_t>(kSgdThreads) * kSgdUnroll * Vec16<T>::kCount;
  const int64_t need = (n + per_block - 1) / per_block;
  const unsigned blocks =
      static_cast<unsigned>(need < kSgdMaxBlocks ? need : kSgdMaxBlocks);
  fused_sgd_kernel<T><<<blocks, kSgdThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<const float*>(eta), wd, static_cast<T*>(out), n);
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

extern "C" int fused_sgd_f32(const void* w, const void* g, const void* eta,
                             float wd, void* out, long long n, void* stream) {
  return launch_sgd<float>(w, g, eta, wd, out, n, stream);
}

extern "C" int fused_sgd_bf16(const void* w, const void* g, const void* eta,
                              float wd, void* out, long long n, void* stream) {
  return launch_sgd<__nv_bfloat16>(w, g, eta, wd, out, n, stream);
}
