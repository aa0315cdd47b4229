// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attn.py::paged_decode.
// For every slot b and kv head k it computes, over the slot's pages of a
// shared K/V pool,
//
//     s_t  = (q[b,k,g] * hd^-0.5) . K[page_map[b, t/ps], t%ps, k]     (f32)
//     out[b,k,g] = sum_t softmax_t(s) V[page_map[b, t/ps], t%ps, k]    (f32)
//
// over the key positions t <= pos[b] (and t > pos[b] - window when window > 0)
// that the slot's P pages hold. q: (B, K, G, hd) f32; pools: (num_pages, ps,
// K, hd) f32 or bf16; page_map: (B, P) int32; pos: (B,) int32; out: (B, K, G,
// hd) f32.
//
// Bound: every live key and value row is read once, so the kernel is bound by
// device memory: the live K/V bytes (plus q and out) over the card's rate. At
// the serve path's main shape (8 slots, K 16, G 1, hd 64, ps 16, P 40, f32,
// pos_b = 80(b+1) - 1) that is 23.6 MB, about 7 us at an H100 SXM's 3.35 TB/s;
// the arithmetic (4 G hd FLOPs a token and kv head) is far below the card's
// balance point.
//
// Design: split-K over positions (flash-decoding), merged in the same launch.
// The TPU kernel walks all P pages of a slot in grid order and carries the
// online softmax in VMEM; one block per (kv head, slot) doing the same here
// runs ~20 dependent load rounds a warp and leaves the SMs idle behind the
// longest slot. Instead:
// - The grid is (n_split, K, B). Split s owns the positions [s*chunk,
//   s*chunk + chunk) of every slot; the wrapper picks chunk (a multiple of the
//   page size when a page fits, at most kMaxChunk positions and 32 KB of K and
//   V rows) and n_split = ceil(P*ps / chunk). A block reads pos[b] and works
//   on its chunk's part of the live range lo = max(0, pos - window + 1) ..
//   hi = min(pos, P*ps - 1): a page outside it is never read. A block whose
//   chunk misses the range leaves at once (it would otherwise hold its SM
//   slot through a fence and an atomic for nothing).
// - The block looks up the page of each of its rows while it reads pos[b],
//   then issues every 16-byte piece of its K and V rows of head k at once
//   with cp.async into shared memory (rows padded by 16 bytes, so a thread
//   per row reads them without bank conflicts), and scales q into shared
//   memory while they fly: one memory round trip a chunk. A pool whose rows are not whole 16-byte
//   pieces (hd * sizeof(T) % 16 != 0) is copied element by element. The G
//   query heads of kv head k share every row the block reads (GQA reuse).
// - A thread per (row, query head) forms the score; a warp per query head
//   takes the chunk's max m and l = sum exp(s - m); a thread per (query
//   head, dim) forms acc = sum p V in row order. The block writes (m, l, acc)
//   per query head to a float32 scratch of shape (B, K, n_split, G, hd + 2).
// - Merge in the same launch: each live block adds one to the arrival
//   counter of (b, k) (an int32 buffer the wrapper zeroes once) after a
//   barrier and thread 0's fence, which make its partial visible to the
//   device first; the last of the live splits lo/chunk .. hi/chunk to
//   arrive merges them in split order, 16 splits a round trip (their m, l
//   and acc loaded at once, the running sums rescaled between batches),
//   writes out and resets the counter to 0. The order is fixed, so the
//   result does not depend on which block arrives last.
// - Masked positions are skipped, never added with a penalty, so garbage in
//   the dummy page cannot leak in: a skipped score would have weighed
//   exp(-1e30 - m) = 0 exactly. A row whose every position is masked (a
//   sliding window past the slot's pages) takes, as the reference does, the
//   uniform mean of its P*ps gathered values: all of them score -1e30, every
//   chunk is live and no block leaves early.
// - expf (not __expf), float32 accumulation, l floored at 1e-30 as the
//   reference's _finish. hd <= 256, G <= 16, B <= 65,535 (grid.z).
//
// C interface (loaded with ctypes): paged_decode_f32 / _bf16 launch on the
// given stream, allocate nothing, and return cudaGetLastError()
// (cudaErrorInvalidValue for a shape outside the limits above or a chunk and
// n_split that do not tile P*ps). Launches that share an arrival buffer must
// run on one stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;  // MAX_HEAD_DIM in kernels/paged_decode.py
constexpr int kMaxGroup = 16;     // MAX_GROUP in kernels/paged_decode.py
constexpr int kMaxChunk = 64;     // MAX_CHUNK in kernels/paged_decode.py
constexpr int kMaxSlots = 65535;  // grid.z
constexpr int kMergeBatch = 16;   // splits the merge loads at once
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a load the compiler keeps where it stands (not sunk behind a branch), so
// that it flies beside the loads after it
__device__ __forceinline__ int ld_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// bytes of one staged K or V row: padded by 16, so that the rows of eight
// neighbouring threads start in eight different 16-byte bank groups
template <typename T>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  return round16(hd * static_cast<int>(sizeof(T))) + 16;
}

// the dynamic shared memory: q (G, hd) f32, scores (G, chunk) f32, K and V
// rows (chunk of row_bytes each)
template <typename T>
__host__ __device__ __forceinline__ int smem_bytes(int G, int hd, int chunk) {
  return round16(G * hd * 4) + round16(G * chunk * 4) +
         2 * chunk * row_bytes<T>(hd);
}

// q . row over hd, 16-byte reads of both when vec
__device__ __forceinline__ float row_dot(const float* q, const float* row,
                                         int hd, bool vec) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (vec) {
    for (int d = 0; d < hd; d += 4) {
      const float4 r = *reinterpret_cast<const float4*>(row + d);
      const float4 x = *reinterpret_cast<const float4*>(q + d);
      a0 = fmaf(x.x, r.x, a0);
      a1 = fmaf(x.y, r.y, a1);
      a2 = fmaf(x.z, r.z, a2);
      a3 = fmaf(x.w, r.w, a3);
    }
  } else {
    for (int d = 0; d < hd; ++d) a0 = fmaf(q[d], row[d], a0);
  }
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ float row_dot(const float* q,
                                         const __nv_bfloat16* row, int hd,
                                         bool vec) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (vec) {
    for (int d = 0; d < hd; d += 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(row + d);
      const float4 x = *reinterpret_cast<const float4*>(q + d);
      const float4 y = *reinterpret_cast<const float4*>(q + d + 4);
      // bf16 -> f32 is exact: the lower half of each word is the first value
      a0 = fmaf(x.x, __uint_as_float(r.x << 16), a0);
      a1 = fmaf(x.y, __uint_as_float(r.x & 0xffff0000u), a1);
      a2 = fmaf(x.z, __uint_as_float(r.y << 16), a2);
      a3 = fmaf(x.w, __uint_as_float(r.y & 0xffff0000u), a3);
      a0 = fmaf(y.x, __uint_as_float(r.z << 16), a0);
      a1 = fmaf(y.y, __uint_as_float(r.z & 0xffff0000u), a1);
      a2 = fmaf(y.z, __uint_as_float(r.w << 16), a2);
      a3 = fmaf(y.w, __uint_as_float(r.w & 0xffff0000u), a3);
    }
  } else {
    for (int d = 0; d < hd; ++d) a0 = fmaf(q[d], to_f32(row[d]), a0);
  }
  return (a0 + a1) + (a2 + a3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_map,
                    const int* __restrict__ pos_arr, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ arrivals,
                    int K, int G, int hd, int ps, int P, int window,
                    float scale, int chunk, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_row[kMaxChunk];  // each row's offset in the pools
  __shared__ bool s_last;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rb = row_bytes<T>(hd);
  float* qs = reinterpret_cast<float*>(smem);
  float* ss = reinterpret_cast<float*>(smem + round16(G * hd * 4));
  unsigned char* ks = smem + round16(G * hd * 4) + round16(G * chunk * 4);
  unsigned char* vs = ks + chunk * rb;

  // the page of every position of the chunk, loaded beside pos[b]
  const int span = P * ps;
  const int c0 = split * chunk;
  int64_t row_off = 0;
  if (threadIdx.x < chunk && c0 + static_cast<int>(threadIdx.x) < span) {
    const int t = c0 + threadIdx.x;
    row_off = (static_cast<int64_t>(
                   ld_now(page_map + static_cast<int64_t>(b) * P + t / ps)) *
                   ps +
               t % ps) *
                  K * hd +
              static_cast<int64_t>(k) * hd;
  }
  const int pos = pos_arr[b];
  int hi = min(pos, span - 1);
  int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = span - 1;
  }
  const int t0 = max(lo, c0);
  const int rows = min(hi, c0 + chunk - 1) - t0 + 1;
  if (rows <= 0) return;  // no live position: the merge does not wait for it
  const int s0 = lo / chunk;  // the live splits
  const int s1 = hi / chunk;
  const int64_t bk = static_cast<int64_t>(b) * K + k;
  const int stride = hd + 2;  // (m, l, acc[hd]) of one query head
  float* my_part = part + (bk * n_split + split) * G * stride;

  // 1. every K and V piece of the chunk's live rows at once
  const int r0 = t0 - c0;
  if (static_cast<int>(threadIdx.x) >= r0 &&
      static_cast<int>(threadIdx.x) < r0 + rows) {
    s_row[threadIdx.x - r0] = row_off;
  }
  __syncthreads();
  if (vec) {
    const int pieces = hd * static_cast<int>(sizeof(T)) / 16;
    const int per_pool = rows * pieces;
    for (int i = threadIdx.x; i < 2 * per_pool; i += kThreads) {
      const bool is_v = i >= per_pool;
      const int j = is_v ? i - per_pool : i;
      const int r = j / pieces;
      const int c = j - r * pieces;
      const T* src = (is_v ? vp : kp) + s_row[r];
      cp_async16((is_v ? vs : ks) + r * rb + c * 16,
                 reinterpret_cast<const unsigned char*>(src) + c * 16);
    }
  } else {
    const int per_pool = rows * hd;
    for (int i = threadIdx.x; i < 2 * per_pool; i += kThreads) {
      const bool is_v = i >= per_pool;
      const int j = is_v ? i - per_pool : i;
      const int r = j / hd;
      const int d = j - r * hd;
      reinterpret_cast<T*>((is_v ? vs : ks) + r * rb)[d] =
          (is_v ? vp : kp)[s_row[r] + d];
    }
  }
  // q * hd^-0.5 of the G query heads of kv head k, while the rows fly
  const float* qb = q + bk * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) qs[i] = qb[i] * scale;
  cp_async_wait_all();
  __syncthreads();

  // 2. the scores, a thread per (query head, row)
  for (int i = threadIdx.x; i < G * rows; i += kThreads) {
    const int g = i / rows;
    const int r = i - g * rows;
    ss[g * chunk + r] =
        all_masked ? kNegInf
                   : row_dot(qs + g * hd,
                             reinterpret_cast<const T*>(ks + r * rb), hd, vec);
  }
  __syncthreads();

  // 3. the chunk's max and exp-sum, a warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float* sg = ss + g * chunk;
    float mx = kNegInf;
    for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sg[r]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int r = lane; r < rows; r += 32) {
      const float p = expf(sg[r] - mx);
      sg[r] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      my_part[g * stride] = mx;
      my_part[g * stride + 1] = l;
    }
  }
  __syncthreads();

  // 4. acc = sum_r p_r V_r in row order, a thread per (query head, dim)
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    const float* pg = ss + g * chunk;
    float a = 0.0f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      a = fmaf(pg[r], to_f32(reinterpret_cast<const T*>(vs + r * rb)[d]), a);
    }
    my_part[g * stride + 2 + d] = a;
  }

  // 5. arrive; the last of the live splits of (b, k) merges. The barrier
  // orders the block's partial writes before thread 0's fence, which makes
  // them visible to the whole device before its arrival counts (as a grid
  // sync does)
  __syncthreads();
  int* counter = arrivals + bk;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counter, 1) == s1 - s0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // 6. merge the live splits in split order, kMergeBatch of them a round
  // trip (the running sums rescaled between batches)
  const float* pbk = part + bk * n_split * G * stride;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float mg = kNegInf;
    float lg = 0.0f;
    float acc = 0.0f;
    for (int sb = s0; sb <= s1; sb += kMergeBatch) {
      float m[kMergeBatch], l[kMergeBatch], a[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        m[j] = kNegInf;
        l[j] = a[j] = 0.0f;
        if (sb + j <= s1) {
          const float* p =
              pbk + (static_cast<int64_t>(sb + j) * G + g) * stride;
          m[j] = __ldcg(p);
          l[j] = __ldcg(p + 1);
          a[j] = __ldcg(p + 2 + d);
        }
      }
      float mb = mg;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) mb = fmaxf(mb, m[j]);
      const float r = expf(mg - mb);
      lg *= r;
      acc *= r;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (sb + j <= s1) {
          const float f = expf(m[j] - mb);
          lg += l[j] * f;
          acc += a[j] * f;
        }
      }
      mg = mb;
    }
    out[bk * G * hd + i] = acc / fmaxf(lg, 1e-30f);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pm,
           const void* pos, void* out, void* part, void* arrivals, int B,
           int K, int G, int hd, int ps, int P, int window, float scale,
           int chunk, int n_split, void* stream) {
  const long long span = static_cast<long long>(P) * ps;
  if (hd < 1 || hd > kMaxHeadDim || G < 1 || G > kMaxGroup || ps < 1 ||
      P < 1 || B < 1 || B > kMaxSlots || K < 1 || K > kMaxSlots ||
      chunk < 1 || chunk > kMaxChunk || n_split < 1 ||
      static_cast<long long>(n_split) * chunk < span ||
      static_cast<long long>(n_split - 1) * chunk >= span) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes<T>(G, hd, chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = hd * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(n_split), static_cast<unsigned>(K),
                  static_cast<unsigned>(B));
  paged_decode_kernel<T><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pm),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(arrivals), K, G, hd, ps, P,
      window, scale, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_f32(const void* q, const void* kp, const void* vp,
                                const void* pm, const void* pos, void* out,
                                void* part, void* arrivals, int B, int K,
                                int G, int hd, int ps, int P, int window,
                                float scale, int chunk, int n_split,
                                void* stream) {
  return launch<float>(q, kp, vp, pm, pos, out, part, arrivals, B, K, G, hd,
                       ps, P, window, scale, chunk, n_split, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* pm,
                                 const void* pos, void* out, void* part,
                                 void* arrivals, int B, int K, int G, int hd,
                                 int ps, int P, int window, float scale,
                                 int chunk, int n_split, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, pm, pos, out, part, arrivals, B, K,
                               G, hd, ps, P, window, scale, chunk, n_split,
                               stream);
}
