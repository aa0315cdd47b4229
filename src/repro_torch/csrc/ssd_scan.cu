// Mamba-2 SSD chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan. For
// every row bh it runs the SSD recurrence
//
//     h_t = exp(loga_t) h_{t-1} + dt_t B_t (x) x_t,   y_t = C_t h_t,   h_0 = 0
//
// in chunks of Q tokens (arXiv:2405.21060). With l the in-chunk cumulative
// log decay (l_t = loga_0 + ... + loga_t), each chunk computes
//
//     intra:  Y  = (L o C B^T o dt) X,  L[t,u] = exp(min(l_t - l_u, 0)), u <= t
//     inter:  Y += (C o exp(l)) H
//     carry:  H  = exp(l_Q) H + (B o exp(l_Q - l) o dt)^T X
//
// x: (BH, T, P) f32 or bf16; dt, loga: (BH, T) f32; B, C: (BH, T, S) in x's
// type; y: (BH, T, P) in x's type; h_final: (BH, S, P) f32. T is a multiple
// of Q (the wrapper pads with zeros: dt = loga = 0 freezes the state).
//
// Bound: per (bh, chunk) the chunked algorithm does Q (Q+1) S + Q (Q+1) P +
// 4 Q S P float32 operations (the causal halves u <= t of C B^T and of M X,
// the carried-state term and the state carry) against 4 (2 Q P + 2 Q S +
// 2 Q) bytes in f32, about 53 operations a byte at Q 256, S 128, P 64:
// above an H100 SXM's f32 balance (67 TFLOP/s over 3.35 TB/s = 20), so the
// scan is bound by its f32 operations on the CUDA cores. At the serve
// path's admission shape (BH 32, T 512) that is 1.35 GFLOP, 20 us.
//
// Design. The TPU grid is (BH, T/Q) with the chunk axis sequential and H
// carried in VMEM scratch. Here:
// - One block per (bh, tile of kPT = 16 columns of P). The columns of H and
//   y are independent, so the tiles give P/16 times more blocks than BH alone
//   (128 for one 32-head admission). Each tile recomputes C B^T: that costs
//   operations (the bound counts them once), and sharing G across the P
//   tiles and the heads of a batch row is later work.
// - The sequential chunk axis is a loop inside the block; the block's
//   S x 16 slice of H stays in shared memory from chunk to chunk.
// - A chunk of B or C at Q 256, S 128 is 128 KB in f32, too large to hold
//   both, so t and u go in strips of kStrip = 64 rows. For each t strip the
//   block loads its C rows, adds the carried-state term, then walks the u
//   strips u <= t: load the B rows, form the masked, decayed 64 x 64 block
//   of M = L o C B^T o dt in shared memory, and add M X. Strips above the
//   diagonal are skipped (causality). The last t strip visits every u strip,
//   so it also accumulates the state carry from the same B rows.
// - l = cumsum(loga) over the chunk is a warp scan in f32 (each lane a run of
//   Q/32 steps, then a shuffle scan of the runs). The decay exponent is
//   clamped to <= 0, as on the TPU: exact on the causal entries (l is
//   non-increasing) and keeping the masked ones from overflowing.
// - Strips and the x tile come in as 16-byte loads (4 floats, or 4 bf16 in
//   8 bytes) into float4 stores, faster than one scalar load a value
//   (PERF.md). The loads are not overlapped with the products: every strip
//   is loaded, then the block synchronises.
// - f32 FMA on the CUDA cores, expf (not __expf). Shared rows of B and C are
//   padded to S + 4 floats, so the float4 reads of 8 neighbouring rows fall
//   on distinct banks. No wgmma or TMA yet.
// Limits (checked by the wrapper, and here): P a multiple of 16, S a
// multiple of 4 and at most 128, the shared memory of the (S, Q) pair within
// 227 KB, and x, B and C aligned to 4 values (16 bytes in f32, 8 in bf16).
//
// C interface (loaded with ctypes): ssd_scan_f32 / _bf16 launch on the given
// stream, allocate nothing, and return cudaGetLastError()
// (cudaErrorInvalidValue for shapes outside the limits).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 64;          // rows of t (and of u) per strip
constexpr int kPT = 16;             // columns of P per block
constexpr int kLdM = kStrip + 1;    // padded row of the M strip block
constexpr int kMaxState = 128;      // MAX_STATE in kernels/ssd_scan.py
constexpr int kMaxSmem = 232448;    // 227 KB, a block's most on an H100

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// shared floats: C and B strips, the M strip block, the chunk's x tile, the
// carried H tile, and l, exp(l), dt, exp(l_Q - l) dt over the chunk.
// smem_bytes in kernels/ssd_scan.py repeats this sum.
__host__ __device__ inline int smem_floats(int S, int Q) {
  return 2 * kStrip * (S + 4) + kStrip * kLdM + Q * kPT + S * kPT + 4 * Q;
}

// four consecutive values as floats, in one 16- (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
// rows [0, rows) of a strip of kStrip rows of S values from a contiguous
// source into shared rows of ldS floats, four values a load; rows past the
// chunk are zero
template <typename T>
__device__ __forceinline__ void load_strip(float* dst, const T* src, int rows,
                                           int S, int ldS) {
  const int s4 = S >> 2;
  const int n = kStrip * s4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / s4;
    const int c = (i - r * s4) << 2;
    const float4 v = r < rows ? load4(src + r * S + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ldS + c) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ loga, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ hfin, int Tn, int P, int S, int Q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldS = S + 4;
  float* cs = smem;                    // (kStrip, ldS) rows of C
  float* bs = cs + kStrip * ldS;       // (kStrip, ldS) rows of B
  float* ms = bs + kStrip * ldS;       // (kStrip, kLdM) block of M
  float* xs = ms + kStrip * kLdM;      // (Q, kPT) the chunk's x tile
  float* hs = xs + Q * kPT;            // (S, kPT) the carried state
  float* lv = hs + S * kPT;            // (Q) l
  float* el = lv + Q;                  // (Q) exp(l)
  float* dtv = el + Q;                 // (Q) dt
  float* wv = dtv + Q;                 // (Q) exp(l_Q - l) dt

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int p0 = blockIdx.y * kPT;
  const int nc = Tn / Q;
  const int ns = (Q + kStrip - 1) / kStrip;
  const T* xb = x + bh * Tn * P;
  const float* dtb = dt + bh * Tn;
  const float* lab = loga + bh * Tn;
  const T* Bb = Bm + bh * Tn * S;
  const T* Cb = Cm + bh * Tn * S;
  T* yb = y + bh * Tn * P;

  // thread roles: the G block (t = gy + 16a, u = gx + 16b, a, b < 4); a row
  // of y (row yr of the strip, columns yc..yc+3); a row of the state carry
  // (s = hr, columns hc..hc+7)
  const int gx = tid % 16, gy = tid / 16;
  const int yr = tid / 4, yc = (tid % 4) * 4;
  const int hr = tid / 2, hc = (tid % 2) * 8;

  for (int i = tid; i < S * kPT; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t t0 = static_cast<int64_t>(c) * Q;
    __syncthreads();  // the previous chunk's readers are done, H is updated
#pragma unroll 4
    for (int i = tid; i < Q * (kPT / 4); i += kThreads) {
      const int r = i / (kPT / 4);
      const int col = (i - r * (kPT / 4)) * 4;
      *reinterpret_cast<float4*>(xs + r * kPT + col) =
          load4(xb + (t0 + r) * P + p0 + col);
    }
    for (int i = tid; i < Q; i += kThreads) {
      dtv[i] = dtb[t0 + i];
      lv[i] = lab[t0 + i];
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of loga: lane runs, then across lanes
      const int per = (Q + 31) / 32;
      const int lo = tid * per;
      const int hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += lv[i];
        lv[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) lv[i] += base;
    }
    __syncthreads();
    const float total = lv[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      el[i] = expf(lv[i]);
      wv[i] = expf(total - lv[i]) * dtv[i];
    }

    float hacc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hacc[j] = 0.f;

    for (int ts = 0; ts < ns; ++ts) {
      const int tb = ts * kStrip;
      __syncthreads();
      load_strip(cs, Cb + (t0 + tb) * S, min(kStrip, Q - tb), S, ldS);
      __syncthreads();
      // the carried-state term exp(l_t) C_t H for this thread's row
      const int t = tb + yr;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < Q) {
        const float* crow = cs + yr * ldS;
        for (int s = 0; s < S; ++s) {
          const float cv = crow[s];
          const float4 hv = *reinterpret_cast<const float4*>(hs + s * kPT + yc);
          acc[0] += cv * hv.x;
          acc[1] += cv * hv.y;
          acc[2] += cv * hv.z;
          acc[3] += cv * hv.w;
        }
        const float e = el[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] *= e;
      }
      for (int us = 0; us <= ts; ++us) {
        const int ub = us * kStrip;
        const int urows = min(kStrip, Q - ub);
        __syncthreads();  // the previous M block and B strip are consumed
        load_strip(bs, Bb + (t0 + ub) * S, urows, S, ldS);
        __syncthreads();
        // G = C_t B_u^T over this strip pair, then M = L o G o dt
        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
#pragma unroll 2
        for (int s = 0; s < S; s += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            cv[a] = *reinterpret_cast<const float4*>(cs + (gy + 16 * a) * ldS + s);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            bv[b] = *reinterpret_cast<const float4*>(bs + (gx + 16 * b) * ldS + s);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              g[a][b] += cv[a].x * bv[b].x;
              g[a][b] += cv[a].y * bv[b].y;
              g[a][b] += cv[a].z * bv[b].z;
              g[a][b] += cv[a].w * bv[b].w;
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int tt = tb + gy + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int uu = ub + gx + 16 * b;
            float m = 0.f;
            if (uu <= tt && tt < Q) {
              m = g[a][b] * expf(fminf(lv[tt] - lv[uu], 0.f)) * dtv[uu];
            }
            ms[(gy + 16 * a) * kLdM + gx + 16 * b] = m;
          }
        }
        if (ts == ns - 1 && hr < S) {
          // the state carry's (B o exp(l_Q - l) o dt)^T X over this u strip
          for (int ul = 0; ul < urows; ++ul) {
            const float bw = bs[ul * ldS + hr] * wv[ub + ul];
            const float* xr = xs + (ub + ul) * kPT + hc;
            const float4 x0 = *reinterpret_cast<const float4*>(xr);
            const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
            hacc[0] += bw * x0.x;
            hacc[1] += bw * x0.y;
            hacc[2] += bw * x0.z;
            hacc[3] += bw * x0.w;
            hacc[4] += bw * x1.x;
            hacc[5] += bw * x1.y;
            hacc[6] += bw * x1.z;
            hacc[7] += bw * x1.w;
          }
        }
        __syncthreads();
        // y += M X over this u strip
        const float* mrow = ms + yr * kLdM;
        for (int ul = 0; ul < urows; ++ul) {
          const float m = mrow[ul];
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (ub + ul) * kPT + yc);
          acc[0] += m * xv.x;
          acc[1] += m * xv.y;
          acc[2] += m * xv.z;
          acc[3] += m * xv.w;
        }
      }
      if (t < Q) {
        T* yo = yb + (t0 + t) * P + p0 + yc;
#pragma unroll
        for (int j = 0; j < 4; ++j) store(yo + j, acc[j]);
      }
    }
    __syncthreads();  // every reader of the old H is done
    if (hr < S) {
      const float et = expf(total);
      float* hrow = hs + hr * kPT + hc;
#pragma unroll
      for (int j = 0; j < 8; ++j) hrow[j] = et * hrow[j] + hacc[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < S * kPT; i += kThreads) {
    const int s = i / kPT;
    hfin[(bh * S + s) * P + p0 + (i - s * kPT)] = hs[i];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* loga, const void* B,
           const void* C, void* y, void* hfin, int BH, int Tn, int P, int S,
           int Q, void* stream) {
  if (BH < 1 || Q < 1 || Tn < Q || Tn % Q || P < kPT || P % kPT || S < 4 ||
      S % 4 || S > kMaxState || P / kPT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = smem_floats(S, Q) * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(P / kPT));
  ssd_scan_kernel<T><<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(loga), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(hfin),
      Tn, P, S, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* loga,
                            const void* B, const void* C, void* y, void* hfin,
                            int BH, int T, int P, int S, int Q, void* stream) {
  return launch<float>(x, dt, loga, B, C, y, hfin, BH, T, P, S, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* loga,
                             const void* B, const void* C, void* y, void* hfin,
                             int BH, int T, int P, int S, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, loga, B, C, y, hfin, BH, T, P, S, Q,
                               stream);
}
