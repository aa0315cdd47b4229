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
// Design. The TPU kernel walks all P pages of a slot in grid order, with the
// page ids scalar-prefetched, and carries the online softmax in VMEM. Here:
// - One block per (kv head k, slot b). The G query heads of that kv head share
//   every K/V row the block reads (GQA reuse); q * hd^-0.5 lives in registers.
// - The block reads its own pos[b] and walks only the live positions
//   max(0, pos - window + 1) .. min(pos, P*ps - 1): a page outside the live
//   range is never read, so the work grows with the live context, not with P.
//   A retired slot's pos keeps growing and its page-map row is all dummy page
//   0; the clamp keeps it inside the row, as the reference clips its page
//   index.
// - Eight warps split the positions, UNROLL consecutive positions per warp per
//   step, so that each lane has 16 loads in flight. Lanes stride over hd
//   (lane + 32 i), so a warp's loads of one row are coalesced. A butterfly
//   shuffle reduction gives every lane each score; each warp keeps its own
//   online-softmax state (m, l, acc) per query head, and the block combines
//   the warps' states in shared memory at the end, in warp order.
// - Masked positions are skipped, never added with a penalty, so garbage in
//   the dummy page cannot leak in: a skipped score would have weighed
//   exp(-1e30 - m) = 0 exactly. A row whose every position is masked (a
//   sliding window past the slot's pages) takes, as the reference does, the
//   uniform mean of its P*ps gathered values: all of them score -1e30.
// - expf (not __expf), float32 accumulation, l floored at 1e-30 as the
//   reference's _finish.
// - hd <= 256 (VEC = ceil(hd / 32) values a lane) and G <= 16 (rounded up to a
//   power of two, GB) are template parameters, so q and acc index registers
//   statically.
// Split-K across blocks (flash-decoding), cp.async or TMA page loads and a
// persistent grid are later work.
//
// C interface (loaded with ctypes): paged_decode_f32 / _bf16 launch on the
// given stream, allocate nothing, and return cudaGetLastError()
// (cudaErrorInvalidValue for hd > kMaxHeadDim or G > kMaxGroup).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;  // MAX_HEAD_DIM in kernels/paged_decode.py
constexpr int kMaxGroup = 16;     // MAX_GROUP in kernels/paged_decode.py
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

template <typename T, int VEC, int GB, int UNROLL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_map,
                    const int* __restrict__ pos_arr, float* __restrict__ out,
                    int K, int G, int hd, int ps, int P, int window,
                    float scale) {
  __shared__ float s_m[kWarps][GB];
  __shared__ float s_l[kWarps][GB];
  __shared__ float s_acc[GB * VEC * 32];

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t q_base = (static_cast<int64_t>(b) * K + k) * G * hd;

  float qr[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < hd) ? q[q_base + g * hd + d] * scale : 0.0f;
    }
  }

  const int pos = pos_arr[b];
  int hi = min(pos, P * ps - 1);
  int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const bool all_masked = lo > hi;
  if (all_masked) {
    lo = 0;
    hi = P * ps - 1;
  }

  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.0f;
  }

  const int* pm = page_map + static_cast<int64_t>(b) * P;
  const int64_t row = static_cast<int64_t>(K) * hd;  // one position of a page
  for (int base = lo + warp * UNROLL; base <= hi; base += kWarps * UNROLL) {
    float kr[UNROLL][VEC], vr[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u;
      if (t <= hi) {
        const int64_t off =
            (static_cast<int64_t>(pm[t / ps]) * ps + t % ps) * row +
            static_cast<int64_t>(k) * hd;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int d = lane + 32 * i;
          kr[u][i] = d < hd ? to_f32(kp[off + d]) : 0.0f;
          vr[u][i] = d < hd ? to_f32(vp[off + d]) : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[u][i] = vr[u][i] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
      float s[UNROLL];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qr[g][i], kr[u][i], part);
        s[u] = all_masked ? kNegInf : warp_sum(part);
        if (base + u <= hi) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (base + u > hi) break;
        const float p = expf(s[u] - mx);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i]);
      }
      m[g] = mx;
    }
  }

  // combine the warps' (m, l, acc), in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  for (int i = threadIdx.x; i < G * hd; i += kThreads) s_acc[i] = 0.0f;
  __syncthreads();
  float factor[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float mg = kNegInf;
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, s_m[w][g]);
    factor[g] = expf(m[g] - mg);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) s_acc[g * hd + d] += acc[g][i] * factor[g];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float mg = kNegInf;
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, s_m[w][g]);
    float lg = 0.0f;
    for (int w = 0; w < kWarps; ++w) lg += s_l[w][g] * expf(s_m[w][g] - mg);
    out[q_base + i] = s_acc[i] / fmaxf(lg, 1e-30f);
  }
}

template <typename T, int VEC, int GB>
void launch_vec_group(const dim3& grid, cudaStream_t st, const float* q,
                      const T* kp, const T* vp, const int* pm,
                      const int* pos, float* out, int K, int G, int hd,
                      int ps, int P, int window, float scale) {
  // 16 loads in flight a lane: UNROLL positions x VEC values x (K, V)
  constexpr int kUnroll = VEC >= 8 ? 1 : 8 / VEC;
  paged_decode_kernel<T, VEC, GB, kUnroll><<<grid, kThreads, 0, st>>>(
      q, kp, vp, pm, pos, out, K, G, hd, ps, P, window, scale);
}

template <typename T, int VEC>
int launch_vec(const dim3& grid, cudaStream_t st, const float* q,
               const T* kp, const T* vp, const int* pm, const int* pos,
               float* out, int K, int G, int hd, int ps, int P, int window,
               float scale) {
  if (G <= 1) {
    launch_vec_group<T, VEC, 1>(grid, st, q, kp, vp, pm, pos, out, K, G, hd,
                                ps, P, window, scale);
  } else if (G <= 2) {
    launch_vec_group<T, VEC, 2>(grid, st, q, kp, vp, pm, pos, out, K, G, hd,
                                ps, P, window, scale);
  } else if (G <= 4) {
    launch_vec_group<T, VEC, 4>(grid, st, q, kp, vp, pm, pos, out, K, G, hd,
                                ps, P, window, scale);
  } else if (G <= 8) {
    launch_vec_group<T, VEC, 8>(grid, st, q, kp, vp, pm, pos, out, K, G, hd,
                                ps, P, window, scale);
  } else if (G <= kMaxGroup) {
    launch_vec_group<T, VEC, 16>(grid, st, q, kp, vp, pm, pos, out, K, G, hd,
                                 ps, P, window, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pm,
           const void* pos, void* out, int B, int K, int G, int hd, int ps,
           int P, int window, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || G < 1 || ps < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(K), static_cast<unsigned>(B));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  const int* pmp = static_cast<const int*>(pm);
  const int* posp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  int err;
  if (hd <= 32) {
    err = launch_vec<T, 1>(grid, st, qp, kt, vt, pmp, posp, op, K, G, hd, ps,
                           P, window, scale);
  } else if (hd <= 64) {
    err = launch_vec<T, 2>(grid, st, qp, kt, vt, pmp, posp, op, K, G, hd, ps,
                           P, window, scale);
  } else if (hd <= 128) {
    err = launch_vec<T, 4>(grid, st, qp, kt, vt, pmp, posp, op, K, G, hd, ps,
                           P, window, scale);
  } else {
    err = launch_vec<T, 8>(grid, st, qp, kt, vt, pmp, posp, op, K, G, hd, ps,
                           P, window, scale);
  }
  static_assert(kMaxHeadDim == 8 * 32, "VEC = 8 covers hd <= 256");
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_f32(const void* q, const void* kp, const void* vp,
                                const void* pm, const void* pos, void* out,
                                int B, int K, int G, int hd, int ps, int P,
                                int window, float scale, void* stream) {
  return launch<float>(q, kp, vp, pm, pos, out, B, K, G, hd, ps, P, window,
                       scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* pm,
                                 const void* pos, void* out, int B, int K,
                                 int G, int hd, int ps, int P, int window,
                                 float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, pm, pos, out, B, K, G, hd, ps, P,
                               window, scale, stream);
}
