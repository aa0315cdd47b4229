// Mamba-2 SSD chunked scan from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan. For
// every row bh (a batch element and head) it runs the SSD recurrence
//
//     h_t = exp(loga_t) h_{t-1} + dt_t B_t (x) x_t,   y_t = C_t h_t,   h_0 = 0
//
// in chunks of Q tokens (arXiv:2405.21060). With l the in-chunk cumulative
// log decay (l_t = loga_0 + ... + loga_t), each chunk computes
//
//     G  = C B^T                                   (per group of heads)
//     intra:  Y  = (L o G) (dt o X),  L[t,u] = exp(min(l_t - l_u, 0)), u <= t
//     inter:  Y += (exp(l) o C) H
//     carry:  H  = exp(l_Q) H + B^T (exp(l_Q - l) o dt o X)
//
// Rows come in groups of heads_per_group consecutive rows that share one row
// of B and C (Mamba-2's single B/C group: all the heads of a batch element).
// x, y: row bh = (group, head) at x + group*xg + head*xh + t*xt + p (the
// TPU kernel's (BH, T, P) or the model's (b, T, H, P), through strides);
// dt, loga likewise (f32); B, C: (groups, T, S) contiguous in x's type;
// h_final: (BH, S, P) f32. T need not be a multiple of Q: rows past T load
// as zeros (dt = loga = 0 freezes the state) and are not stored.
//
// Bound. The algorithm needs Q(Q+1)S operations per (group, chunk) for the
// causal half of G, Q(Q+1)P + 2QSP per (row, chunk) for the causal half of
// the intra product and the carry, and 2QSP per (row, chunk after the
// first) for the carried-state term (the first chunk's H is zero), against
// the bytes of x, y, dt, loga and h per row and of B and C per group. At
// the serve path's admission shape (32 heads of one prompt, T 512, P 64,
// S 128, Q 256) that is 0.69 GFLOP against 10.1 MB: 10.3 us at the f32 rate
// of the CUDA cores (67 TFLOP/s), 4.2 us as three TF32 products on the
// tensor cores (495 TFLOP/s), against 3.0 us of bytes.
//
// Design: two launches on the caller's stream.
// 1. ssd_prep_kernel, two kinds of block in one grid:
//    - Gram blocks: G = C B^T once per (group, chunk), one 32 x 32 tile on
//      or below the diagonal a block, into an f32 scratch of groups x
//      chunks x Qp x Qp (Qp = Q rounded up to 32) that stays in the L2. B
//      and C are read once per group, never per head. Each 16 x 8 tile is
//      stored in the A-fragment order of mma.m16n8k8 (shuffles, one float4
//      store a lane), so that the scan reads it as one float4 a lane. The
//      tile's two halves of S arrive as two cp.async groups.
//    - Chunk-state blocks, nsplit per (row, 16 columns of P, chunk): each
//      the sum over 1 / nsplit of the chunk's rows u of its state from
//      zero, B^T (exp(l_Q - l) o dt o X), over strips of 16 rows of B in a
//      three-slot cp.async ring, and the chunk's total decay l_Q. The
//      chunks' states are independent, so this runs over every chunk at
//      once. The wrapper picks nsplit so that the blocks fill the card (2
//      at the serve shape, 1 at the forward shape).
// 2. ssd_scan_kernel, one block of 8 warps per (row, 16 columns of P,
//    chunk), two blocks an SM: H entering the chunk is the earlier chunks'
//    states, each decayed by the chunks after it (S x 16 values a block);
//    then the block walks the chunk's stages through a two-slot cp.async
//    ring (the next stage's copy overlaps the current stage's products):
//    - C stages (chunks after the first): 16 columns of C for the chunk's
//      rows; Y += (exp(l) o C) H.
//    - U stages, one per 16 columns u of the chunk: the G tiles of the strip
//      (rows t >= u only), formed into M = L o G with the clamped
//      exp2(min(l2_t - l2_u, 0)) (l2 = l log2 e) in registers, Y += M (dt o
//      X).
//    The x tile arrives with the first U stage, dt and loga with the first
//    stage; l is a warp scan in f32. Warp w owns the 16-row tiles w and
//    15 - w of each 256 rows (equal causal work). Chunks longer than 256
//    rows run in passes of 256. The last chunk's block writes h_final.
//    Drafts that ran the chunk loop inside one block (the carry in the
//    block), a deeper ring, 8 columns or 16 warps a block were slower at
//    the serve shape (PERF.md).
// - The scan is launched as a programmatic dependent of the first grid:
//   its blocks start while that grid runs and wait (griddepcontrol.wait)
//   before they read G or a chunk state.
// - Every product is mma.sync.m16n8k8 TF32 in 3xTF32: each f32 operand is
//   split into a TF32 high part and the TF32-rounded rest, and hi*lo + lo*hi
//   + hi*hi accumulate in f32 (about 2^-21 relative per product, within the
//   SSD tolerance of 1e-4 of max |y|). bf16 inputs convert to f32 on load.
// - Shared rows are padded so that every fragment read of a warp falls on 32
//   distinct banks (C rows 20 floats, B rows S + 8, x and H rows 24).
// - At S 128, Q 256 in f32 a scan block takes 81,920 B of shared memory,
//   a first-launch block 52,736 B.
// Limits (checked by the wrapper, and here): P a multiple of 16, S a
// multiple of 4 and at most 128, the shared memory of scan_layout within
// 227 KB, x, B and C aligned to 4 values and x's strides multiples of 4.
//
// C interface (loaded with ctypes): ssd_scan_f32 / _bf16 launch both kernels
// on the given stream, allocate nothing (the wrapper passes the scratch: G,
// the chunk states, the chunks' total decays), and return cudaGetLastError()
// (cudaErrorInvalidValue for shapes outside the limits).
// ssd_scan_smem_bytes(S, Q, item) returns the larger block's shared memory
// of the two kernels, which the wrapper holds to the limit before a launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a block of either kernel: 8 warps
constexpr int kPT = 16;             // columns of P per block
constexpr int kNT = kPT / 8;        // their n8 tiles
constexpr int kLdX = kPT + 8;       // padded row of the x tile and of H
constexpr int kPass = 256;          // rows of a chunk per pass (16 tiles)
constexpr int kKU = 16;             // columns u of G per U stage, rows of B
constexpr int kKS = 16;             // columns s of C per C stage
constexpr int kLdC = kKS + 4;       // padded row of a C strip
constexpr int kGTile = kPass / 16 * 2 * 128;  // floats of a U stage's G
constexpr int kBSlots = 3;          // the chunk-state blocks' ring of B rows
constexpr int kSlots = 2;           // the scan's ring of stages
constexpr int kMaxState = 128;      // MAX_STATE in kernels/ssd_scan.py
constexpr int kMaxSmem = 232448;    // 227 KB, a block's most on an H100
constexpr int kMaxChunk = 1 << 20;  // keeps the layouts' sums within an int
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The scan kernel's shared memory, in bytes from the start: the ring's
// slots (a U stage's G tiles, or a C stage's C rows), the x tile, H, and
// the f32 vectors (dt, loga then l, l2, exp(l)). ssd_scan_smem_bytes
// exports the larger of this and the first kernel's.
struct Layout {
  int slot, x, h, vec, total;
};
__host__ __device__ inline Layout scan_layout(int S, int Q, int item) {
  const int Qp = round_up(Q, 32), Sp = round_up(S, 16);
  Layout L;
  const int u_stage = kGTile * 4;
  const int c_stage = kPass * kLdC * item;
  L.slot = u_stage > c_stage ? u_stage : c_stage;
  L.x = kSlots * L.slot;
  L.h = L.x + Qp * kLdX * item;
  L.vec = L.h + Sp * kLdX * 4;
  L.total = L.vec + 4 * Qp * 4;
  return L;
}
// The first kernel's: a Gram block's C and B rows, or a chunk-state
// block's ring of B rows, x tile and f32 vectors (dt, loga then l).
__host__ __device__ inline int gram_smem_bytes(int S, int item) {
  return 2 * 32 * (round_up(S, 8) + 4) * item;
}
__host__ __device__ inline int state_smem_bytes(int S, int Q, int item) {
  const int Qp = round_up(Q, 32), Sp = round_up(S, 16);
  return kBSlots * kKU * (Sp + 8) * item + Qp * kLdX * item + 2 * Qp * 4;
}
__host__ __device__ inline int prep_smem_bytes(int S, int Q, int item) {
  const int g = gram_smem_bytes(S, item), s = state_smem_bytes(S, Q, item);
  return g > s ? g : s;
}

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four values (16 bytes in f32, 8 in bf16); zeros when !ok
template <typename T>
__device__ __forceinline__ void cp4(T* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp1(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32 (10 mantissa bits), each rounded to nearest
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  const float rest = v - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32: the small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
}

struct Strides {
  int64_t xg, xh, xt;   // x and y: group, head, token
  int64_t dg, dh, dtt;  // dt and loga
  int64_t yg, yh, yt;
};

// l = the inclusive scan of loga over the chunk's Qp values, in place, by
// one warp: each lane a run of Qp / 32, then a shuffle scan of the runs
__device__ __forceinline__ void warp_cumsum(float* l, int Qp, int lane) {
  const int per = Qp / 32;
  const int lo = lane * per;
  float run = 0.f;
  for (int i = lo; i < lo + per; ++i) {
    run += l[i];
    l[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float base = incl - run;
  for (int i = lo; i < lo + per; ++i) l[i] += base;
}

// ---------------------------------------------------------------------------
// 1a. G = C B^T of a (group, chunk), one 32 x 32 tile with u-tile <= t-tile
// (warps 0-3 compute; all eight load).
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void gram_block(const T* __restrict__ Bm,
                                           const T* __restrict__ Cm,
                                           float* __restrict__ G, int Tn,
                                           int S, int Q, int nc, int ntiles,
                                           int gi, char* sm) {
  const int S8 = round_up(S, 8);
  const int ld = S8 + 4;
  T* cs = reinterpret_cast<T*>(sm);
  T* bs = cs + 32 * ld;
  const int Qp = round_up(Q, 32);
  const int gc = gi / ntiles;
  const int64_t grp = gc / nc;
  const int c = gc - static_cast<int>(grp) * nc;
  int a = 0, b = gi - gc * ntiles;
  while (b > a) b -= ++a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rows = min(Q, Tn - c * Q);
  const int64_t t0 = grp * Tn + static_cast<int64_t>(c) * Q;

  // two halves of S, one cp.async group each
  const int nk = S8 / 8;
  const int half = (nk + 1) / 2 * 8;
  const int s4 = S8 / 4;
  for (int h = 0; h < 2; ++h) {
    for (int i = tid; i < 2 * 32 * s4; i += kThreads) {
      const int which = i / (32 * s4);  // 0: C rows of tile a, 1: B of b
      const int r = (i / s4) % 32;
      const int col = (i % s4) * 4;
      if ((col < half) != (h == 0)) continue;
      const int row = (which ? b : a) * 32 + r;
      const T* base = which ? Bm : Cm;
      const bool ok = row < rows && col < S;
      cp4((which ? bs : cs) + r * ld + col,
          ok ? base + (t0 + row) * S + col : base, ok);
    }
    cp_commit();
  }

  const int wy = (warp >> 1) & 1, wx = warp & 1;
  float acc[2][4] = {}, corr[2][4] = {};  // hi*hi, and lo*hi + hi*lo
  for (int h = 0; h < 2; ++h) {
    if (h == 0) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();
    if (warp >= 4) continue;
    const int k0 = h == 0 ? 0 : half, k1 = h == 0 ? half : S8;
    for (int k = k0; k < k1; k += 8) {
      const T* cr = cs + (16 * wy + g) * ld + k + tq;
      const float av[4] = {tof(cr[0]), tof(cr[8 * ld]), tof(cr[4]),
                           tof(cr[8 * ld + 4])};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const T* br = bs + (16 * wx + 8 * n + g) * ld + k + tq;
        uint32_t bh[2], bl[2];
        split(tof(br[0]), bh[0], bl[0]);
        split(tof(br[4]), bh[1], bl[1]);
        mma(corr[n], al, bh[0], bh[1]);
        mma(corr[n], ah, bl[0], bl[1]);
        mma(acc[n], ah, bh[0], bh[1]);
      }
    }
  }
  if (warp >= 4) return;
  // C fragment -> the A-fragment order of the 16 x 8 tile (i, kk): lane
  // (g, tq) holds (g, 2tq), (g, 2tq + 1), (g + 8, 2tq), (g + 8, 2tq + 1)
  // and needs (g, tq), (g + 8, tq), (g, tq + 4), (g + 8, tq + 4), held by
  // lanes (g, tq / 2) and (g, 2 + tq / 2); one float4 store a lane
  float* out = G + (grp * nc + c) * static_cast<int64_t>(Qp) * Qp;
  const int i = 2 * a + wy;
  const int src0 = (lane & ~3) | (tq >> 1), src1 = src0 + 2, odd = tq & 1;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float v[4], w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = corr[n][e] + acc[n][e];
      v[e] = __shfl_sync(0xffffffffu, f, src0);
      w[e] = __shfl_sync(0xffffffffu, f, src1);
    }
    const int kk = 4 * b + 2 * wx + n;
    float* tile = out + (static_cast<int64_t>(i) * (Qp / 8) + kk) * 128;
    *reinterpret_cast<float4*>(tile + lane * 4) =
        make_float4(odd ? v[1] : v[0], odd ? v[3] : v[2], odd ? w[1] : w[0],
                    odd ? w[3] : w[2]);
  }
}

// ---------------------------------------------------------------------------
// 1b. One part of the state of a (row, 16 columns of P, chunk) from a zero
// state, H_c = B^T (exp(l_Q - l) o dt o X), summed over the part's rows u
// (1 / nsplit of the chunk), and the chunk's total decay l_Q: warp w the
// rows 16w .. 16w + 15 of H_c, over strips of 16 rows u of B in a ring of
// kBSlots.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void state_block(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ loga, const T* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ totals,
    const Strides& st, int Tn, int P, int S, int Q, int hpg, int nsplit,
    int si, char* sm) {
  const int Qp = round_up(Q, 32), Sp = round_up(S, 16);
  const int ldB = Sp + 8;
  const int nc = (Tn + Q - 1) / Q;
  const int part = si % nsplit;
  const int c = si / nsplit % nc;
  const int pt = si / nsplit / nc % (P / kPT);
  const int64_t bh = si / nsplit / nc / (P / kPT);
  const int64_t grp = bh / hpg, head = bh - grp * hpg;
  const int p0 = pt * kPT;
  T* bring = reinterpret_cast<T*>(sm);                        // B rows
  T* xs = reinterpret_cast<T*>(sm + kBSlots * kKU * ldB * sizeof(T));
  float* dtv = reinterpret_cast<float*>(xs + Qp * kLdX);      // dt, then w
  float* lv = dtv + Qp;                                       // loga, then l
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rows = min(Q, Tn - c * Q);
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const T* xb = x + grp * st.xg + head * st.xh + p0;
  const float* dtb = dt + grp * st.dg + head * st.dh;
  const float* lab = loga + grp * st.dg + head * st.dh;
  const T* Bb = Bm + grp * Tn * S;

  for (int r = tid; r < Qp; r += kThreads) {
    const bool ok = r < rows;
    cp1(dtv + r, ok ? dtb + (t0 + r) * st.dtt : dtb, ok);
    cp1(lv + r, ok ? lab + (t0 + r) * st.dtt : lab, ok);
  }
  // the part's strips of 16 rows u, and its rows of the x tile
  const int nu = Qp / kKU / nsplit, j0 = part * nu;
  for (int i = tid; i < nu * kKU * (kPT / 4); i += kThreads) {
    const int r = j0 * kKU + i / (kPT / 4), col = (i % (kPT / 4)) * 4;
    const bool ok = r < rows;
    cp4(xs + r * kLdX + col, ok ? xb + (t0 + r) * st.xt + col : xb, ok);
  }
  cp_commit();
  auto issue = [&](int jj) {  // rows [16 j, 16 j + 16) of B, j = j0 + jj
    if (jj < nu) {
      const int j = j0 + jj;
      T* bs = bring + (jj % kBSlots) * kKU * ldB;
      for (int i = tid; i < kKU * (Sp / 4); i += kThreads) {
        const int r = i / (Sp / 4), col = (i % (Sp / 4)) * 4;
        const int u = j * kKU + r;
        const bool ok = u < rows && col < S;
        cp4(bs + r * ldB + col, ok ? Bb + (t0 + u) * S + col : Bb, ok);
      }
    }
    cp_commit();
  };
  for (int j = 0; j < kBSlots - 1; ++j) issue(j);
  cp_wait<kBSlots - 1>();
  __syncthreads();
  if (warp == 0) warp_cumsum(lv, Qp, lane);
  __syncthreads();
  const float total = lv[Qp - 1];
  for (int i = tid; i < Qp; i += kThreads) dtv[i] *= expf(total - lv[i]);

  float hc[kNT][4] = {};
  for (int jj = 0; jj < nu; ++jj) {
    const int j = j0 + jj;
    issue(jj + kBSlots - 1);
    cp_wait<kBSlots - 1>();
    __syncthreads();
    if (16 * warp < Sp) {
      const T* bs = bring + (jj % kBSlots) * kKU * ldB;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t xh[kNT][2], xl[kNT][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = j * kKU + 8 * kk + tq + 4 * e;
          const float f = dtv[u];
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            split(tof(xs[u * kLdX + 8 * n + g]) * f, xh[n][e], xl[n][e]);
        }
        const T* br = bs + (8 * kk + tq) * ldB + 16 * warp + g;
        const float av[4] = {tof(br[0]), tof(br[8]), tof(br[4 * ldB]),
                             tof(br[4 * ldB + 8])};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
#pragma unroll
        for (int n = 0; n < kNT; ++n) mma3(hc[n], ah, al, xh[n], xl[n]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  if (16 * warp < Sp) {
    float* out = states +
                 ((bh * nc + c) * nsplit + part) * static_cast<int64_t>(S) * P +
                 p0;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * warp + g + 8 * (e >> 1);
        if (s < S) out[s * P + 8 * n + 2 * tq + (e & 1)] = hc[n][e];
      }
  }
  if (pt == 0 && part == 0 && tid == 0) totals[bh * nc + c] = total;
}

// The first launch: n_gram Gram blocks, then the chunk-state blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_prep_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ loga, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, float* __restrict__ G,
                    float* __restrict__ states, float* __restrict__ totals,
                    Strides st, int Tn, int P, int S, int Q, int hpg,
                    int nsplit, int n_gram, int ntiles) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  // the scan may launch now; it waits for this grid before it reads G
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int nc = (Tn + Q - 1) / Q;
  if (static_cast<int>(blockIdx.x) < n_gram) {
    gram_block<T>(Bm, Cm, G, Tn, S, Q, nc, ntiles, blockIdx.x, sm);
  } else {
    state_block<T>(x, dt, loga, Bm, states, totals, st, Tn, P, S, Q, hpg,
                   nsplit, blockIdx.x - n_gram, sm);
  }
}

// ---------------------------------------------------------------------------
// 2. The scan of one chunk: grid (BH, P / kPT, chunks), kThreads threads.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ loga, const T* __restrict__ Cm,
                    const float* __restrict__ G,
                    const float* __restrict__ states,
                    const float* __restrict__ totals, T* __restrict__ y,
                    float* __restrict__ hfin, Strides st, int Tn, int P,
                    int S, int Q, int hpg, int nsplit) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const Layout L = scan_layout(S, Q, sizeof(T));
  const int Qp = round_up(Q, 32), Sp = round_up(S, 16);
  T* xs = reinterpret_cast<T*>(sm + L.x);          // (Qp, kLdX) x tile
  float* hs = reinterpret_cast<float*>(sm + L.h);  // (Sp, kLdX) H
  float* dtc = reinterpret_cast<float*>(sm + L.vec);  // (Qp) dt
  float* lc = dtc + Qp;                               // (Qp) loga, then l
  float* l2v = lc + Qp;                               // (Qp) l log2 e
  float* elv = l2v + Qp;                              // (Qp) exp(l)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t grp = bh / hpg, head = bh - grp * hpg;
  const int p0 = blockIdx.y * kPT;
  const int c = blockIdx.z;
  const int nc = (Tn + Q - 1) / Q;
  const int np = (Qp + kPass - 1) / kPass;
  const int nC = c > 0 ? Sp / kKS : 0;   // C stages a pass (none from H = 0)
  const int rows = min(Q, Tn - c * Q);
  const int64_t t0 = static_cast<int64_t>(c) * Q;
  const T* xb = x + grp * st.xg + head * st.xh + p0;
  const float* dtb = dt + grp * st.dg + head * st.dh;
  const float* lab = loga + grp * st.dg + head * st.dh;
  T* yb = y + grp * st.yg + head * st.yh + p0;
  const T* Cb = Cm + grp * Tn * S;
  const float* Gc = G + (grp * nc + c) * static_cast<int64_t>(Qp) * Qp;

  // the stages: per pass its C stages, then its U stages
  auto n_u = [&](int p) { return min(Qp, kPass * (p + 1)) / kKU; };
  int ns = 0;
  for (int p = 0; p < np; ++p) ns += nC + n_u(p);
  // stage k -> (pass, is a U stage, index in its kind)
  auto decode = [&](int k, int& p, bool& u_stage, int& idx) {
    for (p = 0; p < np; ++p) {
      if (k < nC) {
        u_stage = false;
        idx = k;
        return;
      }
      k -= nC;
      if (k < n_u(p)) {
        u_stage = true;
        idx = k;
        return;
      }
      k -= n_u(p);
    }
  };
  auto issue = [&](int k) {
    if (k < ns) {
      int p, idx;
      bool u_stage;
      decode(k, p, u_stage, idx);
      char* sl = sm + (k % kSlots) * L.slot;
      if (k == 0) {  // the chunk's dt and loga
        for (int r = tid; r < Qp; r += kThreads) {
          const bool ok = r < rows;
          cp1(dtc + r, ok ? dtb + (t0 + r) * st.dtt : dtb, ok);
          cp1(lc + r, ok ? lab + (t0 + r) * st.dtt : lab, ok);
        }
      }
      if (!u_stage) {  // C rows of the pass, columns [16 idx, 16 idx + 16)
        T* cs = reinterpret_cast<T*>(sl);
        const int r0 = p * kPass, nr = min(kPass, Qp - r0), s0 = idx * kKS;
        for (int i = tid; i < nr * (kKS / 4); i += kThreads) {
          const int r = i / (kKS / 4), col = s0 + (i % (kKS / 4)) * 4;
          const bool ok = r0 + r < rows && col < S;
          cp4(cs + r * kLdC + col - s0,
              ok ? Cb + (t0 + r0 + r) * S + col : Cb, ok);
        }
      } else {
        const int j = idx;
        if (p == 0 && j == 0) {  // the chunk's x tile, with its first U stage
          for (int i = tid; i < Qp * (kPT / 4); i += kThreads) {
            const int r = i / (kPT / 4), col = (i % (kPT / 4)) * 4;
            const bool ok = r < rows;
            cp4(xs + r * kLdX + col, ok ? xb + (t0 + r) * st.xt + col : xb,
                ok);
          }
        }
        // G tiles (i, 2j) and (i, 2j + 1) of the pass's row tiles i >= j
        float* gs = reinterpret_cast<float*>(sl);
        const int ilo = max(p * 16, j), ihi = min(p * 16 + 16, Qp / 16);
        for (int i = tid; i < (ihi - ilo) * 64; i += kThreads) {
          const int mt = ilo + i / 64, q = (i % 64) * 4;
          asm volatile(
              "cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                  smem_addr(gs + (mt - p * 16) * 256 + q)),
              "l"(Gc + (static_cast<int64_t>(mt) * (Qp / 8) + 2 * j) * 128 +
                  q)
              : "memory");
        }
      }
    }
    cp_commit();
  };

  // the Gram grid's G and the chunk states are read from here on
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int k = 0; k < kSlots - 1; ++k) issue(k);
  // H entering the chunk: the earlier chunks' states (the sums of their
  // parts), each decayed by the chunks after it; the last chunk's block
  // also writes h_final
  const float* sb =
      states + bh * nc * nsplit * static_cast<int64_t>(S) * P + p0;
  auto state = [&](int k, int s, int col) {
    float v = 0.f;
    for (int q = 0; q < nsplit; ++q)
      v += sb[((static_cast<int64_t>(k) * nsplit + q) * S + s) * P + col];
    return v;
  };
  for (int i = tid; i < Sp * kPT; i += kThreads) {
    const int s = i / kPT, col = i - s * kPT;
    float h = 0.f;
    if (s < S) {
      for (int k = 0; k < c; ++k)
        h = expf(totals[bh * nc + k]) * h + state(k, s, col);
      if (c == nc - 1) {
        hfin[(bh * S + s) * P + p0 + col] =
            expf(totals[bh * nc + c]) * h + state(c, s, col);
      }
    }
    hs[s * kLdX + col] = h;
  }

  float acc[2][kNT][4] = {};  // Y: the warp's two row tiles
  for (int k = 0; k < ns; ++k) {
    issue(k + kSlots - 1);
    cp_wait<kSlots - 1>();
    __syncthreads();
    if (k == 0) {
      if (warp == 0) warp_cumsum(lc, Qp, lane);
      __syncthreads();
      for (int i = tid; i < Qp; i += kThreads) {
        const float l = lc[i];
        l2v[i] = l * kLog2e;
        elv[i] = expf(l);
      }
      __syncthreads();
    }
    int p, idx;
    bool u_stage;
    decode(k, p, u_stage, idx);
    const char* sl = sm + (k % kSlots) * L.slot;
    const int tiles[2] = {p * 16 + warp, p * 16 + 15 - warp};
    if (!u_stage) {
      // Y += (exp(l) o C) H over s in [16 idx, 16 idx + 16)
      const T* cs = reinterpret_cast<const T*>(sl);
      uint32_t bh2[2][kNT][2], bl2[2][kNT][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split(hs[(idx * kKS + 8 * kk + tq + 4 * e) * kLdX + 8 * n + g],
                  bh2[kk][n][e], bl2[kk][n][e]);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = tiles[a];
        if (16 * i >= Qp) continue;
        const int r = 16 * i + g;
        const float e0 = elv[r], e1 = elv[r + 8];
        const T* cr = cs + (r - p * kPass) * kLdC + tq;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float av[4] = {tof(cr[8 * kk]) * e0,
                               tof(cr[8 * kLdC + 8 * kk]) * e1,
                               tof(cr[8 * kk + 4]) * e0,
                               tof(cr[8 * kLdC + 8 * kk + 4]) * e1};
          uint32_t ah[4], al[4];
          split4(av, ah, al);
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mma3(acc[a][n], ah, al, bh2[kk][n], bl2[kk][n]);
        }
      }
    } else {
      const int j = idx;
      // B operands dt o X over u in the strip, split by each warp
      uint32_t xh[2][kNT][2], xl[2][kNT][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = j * kKU + 8 * kk + tq + 4 * e;
          const float f = dtc[u];
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            split(tof(xs[u * kLdX + 8 * n + g]) * f, xh[kk][n][e],
                  xl[kk][n][e]);
        }
      const float* gs = reinterpret_cast<const float*>(sl);
      // Y += (L o G) (dt o X) on the warp's row tiles i >= j
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = tiles[a];
        if (16 * i >= Qp || i < j) continue;
        const int r = 16 * i + g;
        const float lr0 = l2v[r], lr1 = l2v[r + 8];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float4 gv = *reinterpret_cast<const float4*>(
              gs + (i - p * 16) * 256 + kk * 128 + lane * 4);
          const int u0 = j * kKU + 8 * kk + tq, u1 = u0 + 4;
          const float lu0 = l2v[u0], lu1 = l2v[u1];
          float mv[4] = {gv.x * ex2(fminf(lr0 - lu0, 0.f)),
                         gv.y * ex2(fminf(lr1 - lu0, 0.f)),
                         gv.z * ex2(fminf(lr0 - lu1, 0.f)),
                         gv.w * ex2(fminf(lr1 - lu1, 0.f))};
          if (i == j) {  // the diagonal tile: u <= t only
            mv[0] = u0 <= r ? mv[0] : 0.f;
            mv[1] = u0 <= r + 8 ? mv[1] : 0.f;
            mv[2] = u1 <= r ? mv[2] : 0.f;
            mv[3] = u1 <= r + 8 ? mv[3] : 0.f;
          }
          uint32_t ah[4], al[4];
          split4(mv, ah, al);
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mma3(acc[a][n], ah, al, xh[kk][n], xl[kk][n]);
        }
      }
      if (j == n_u(p) - 1) {  // the pass's last stage: store its rows of y
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = tiles[a];
          if (16 * i >= Qp) continue;
          const int r = 16 * i + g;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int col = 8 * n + 2 * tq;
            if (r < rows)
              store2(yb + (t0 + r) * st.yt + col, acc[a][n][0],
                     acc[a][n][1]);
            if (r + 8 < rows)
              store2(yb + (t0 + r + 8) * st.yt + col, acc[a][n][2],
                     acc[a][n][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
}

// the scan, launched to overlap the first grid's tail (programmatic
// dependent launch: its blocks wait at griddepcontrol.wait for G and the
// chunk states)
template <typename T>
cudaError_t launch_scan(const void* x, const void* dt, const void* loga,
                        const void* C, const float* gram,
                        const float* states, const float* totals, void* y,
                        void* hfin, int groups, int hpg, int Tn, int P, int S,
                        int Q, int nsplit, const Strides& st,
                        cudaStream_t s) {
  const int bytes = scan_layout(S, Q, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * hpg),
                     static_cast<unsigned>(P / kPT),
                     static_cast<unsigned>((Tn + Q - 1) / Q));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, ssd_scan_kernel<T>, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(loga),
      static_cast<const T*>(C), gram, states, totals, static_cast<T*>(y),
      static_cast<float*>(hfin), st, Tn, P, S, Q, hpg, nsplit);
}

template <typename T>
int launch(const void* x, const void* dt, const void* loga, const void* B,
           const void* C, void* y, void* hfin, void* scratch, int groups,
           int hpg, int Tn, int P, int S, int Q, int nsplit,
           const Strides& st, void* stream) {
  if (groups < 1 || hpg < 1 || Q < 1 || Q > kMaxChunk || Tn < 1 ||
      P < kPT || P % kPT ||
      S < 4 || S % 4 || S > kMaxState || P / kPT > 65535 || nsplit < 1 ||
      round_up(Q, 32) / kKU % nsplit ||
      static_cast<int64_t>(groups) * hpg >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = (Tn + Q - 1) / Q;
  const int Qp = round_up(Q, 32);
  const int na = Qp / 32, ntiles = na * (na + 1) / 2;
  const int64_t rows = static_cast<int64_t>(groups) * hpg;
  const int64_t n_gram = static_cast<int64_t>(groups) * nc * ntiles;
  const int64_t n_state = rows * (P / kPT) * nc * nsplit;
  const int prep_bytes = prep_smem_bytes(S, Q, sizeof(T));
  if (scan_layout(S, Q, sizeof(T)).total > kMaxSmem ||
      prep_bytes > kMaxSmem || nc > 65535 ||
      n_gram + n_state >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scratch: G (groups x chunks x Qp x Qp), the chunk states' parts
  // (rows x chunks x nsplit x S x P), the chunks' total decays (rows x
  // chunks)
  float* gram = static_cast<float*>(scratch);
  float* states = gram + static_cast<int64_t>(groups) * nc * Qp * Qp;
  float* totals = states + rows * nc * nsplit * S * P;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_prep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      prep_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_prep_kernel<T><<<static_cast<unsigned>(n_gram + n_state), kThreads,
                       prep_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(loga), static_cast<const T*>(B),
      static_cast<const T*>(C), gram, states, totals, st, Tn, P, S, Q, hpg,
      nsplit, static_cast<int>(n_gram), ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_scan<T>(x, dt, loga, C, gram, states, totals, y, hfin, groups,
                       hpg, Tn, P, S, Q, nsplit, st, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/y strides (group, head, token) and dt/loga strides, in elements; the
// last dimension of x and y and of B and C is contiguous
#define SSD_ARGS                                                             \
  const void *x, const void *dt, const void *loga, const void *B,           \
      const void *C, void *y, void *hfin, void *scratch, int groups,        \
      int hpg, int T, int P, int S, int Q, int splits, int64_t xg,          \
      int64_t xh, int64_t xt, int64_t dg, int64_t dh, int64_t dtt,          \
      int64_t yg, int64_t yh, int64_t yt, void *stream

extern "C" int ssd_scan_f32(SSD_ARGS) {
  const Strides st{xg, xh, xt, dg, dh, dtt, yg, yh, yt};
  return launch<float>(x, dt, loga, B, C, y, hfin, scratch, groups, hpg, T, P,
                       S, Q, splits, st, stream);
}

extern "C" int ssd_scan_bf16(SSD_ARGS) {
  const Strides st{xg, xh, xt, dg, dh, dtt, yg, yh, yt};
  return launch<__nv_bfloat16>(x, dt, loga, B, C, y, hfin, scratch, groups, hpg,
                               T, P, S, Q, splits, st, stream);
}

extern "C" int ssd_scan_smem_bytes(int S, int Q, int item) {
  if (Q < 1 || Q > kMaxChunk || S < 1 || S > kMaxState) return 0x7fffffff;
  const int scan = scan_layout(S, Q, item).total;
  const int prep = prep_smem_bytes(S, Q, item);
  return scan > prep ? scan : prep;
}
