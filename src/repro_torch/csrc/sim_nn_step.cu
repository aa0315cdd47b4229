// The simulation's local SGD step of the one-hidden-layer network
// (models/simple.py::nn) as two passes over the fleet's w1, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves this step to XLA inside
// vmap(grad(loss)). It was added because the step's w1 passes are most of
// the simulation's time: autograd's backward, the L2 term's pow, sum and
// backward, the separate multiply by eta, the subtraction and, under churn,
// the dark devices' mask each take a pass over the 3.07 GB fleet-sized
// w1 (I = 125 devices of 784 x 7,840 f32). One SGD step needs three: read
// w1 for the forward, read and write it for the update.
//
// sim_nn_forward_kernel: H_i = relu(X_i W1_i + b1_i) for every device i,
// X (I, B, m), W1 (I, m, hid), b1 (I, hid), H (I, B, hid), and each column
// tile's share of the logits H_i W2_i, W2 (I, hid, C), so that the logits
// need no second read of H (cuBLAS's batched product of a 16 x 7,840 by a
// 7,840 x 10 matrix per device took 0.24 ms, a tenth of the step's
// non-kernel time; here it is some 800 shuffles a thread in the epilogue).
// One block per (column tile, device): 128 threads, each owning four
// neighbouring columns (a float4: hid is a multiple of 4 and the vector
// operands are 16-byte aligned), so a warp reads 512 contiguous bytes of a
// row of W1. Each thread streams its columns of W1_i row by row through a
// ring of kStages slots in shared memory, filled by cp.async (a thread
// copies and reads its own 16 bytes, so the ring needs cp.async.wait_group
// and no barrier); with
// kStages - 1 rows in flight a thread, about 7 KB a block and 35 KB an SM at
// five blocks an SM. X_i is staged in shared memory kChunk rows at a time,
// transposed (xs[k][b]) so that one row's B values are 16-byte broadcasts.
// The B x 4 sums stay in registers; the products are f32 fmaf (no TF32). At
// B = 16 the kernel does 8 operations a byte of W1, below the card's f32
// ridge, so one read of W1 bounds it: 0.917 ms at (125, 16, 784, 7840).
//
// sim_nn_update_kernel: W1_i <- W1_i - eta * (X_i^T dH_i + reg * W1_i) in
// place, dH (I, B, hid). One block per (column tile, block of kRows rows,
// device). A thread holds its columns of dH_i (B x 4 values) in registers and
// the block's rows of X_i in shared memory, streams its W1 values through the
// same cp.async ring and writes each once (st.global.cs). One read and one
// write of W1 bound it: 1.835 ms at the main shape. The arithmetic is
// rounded as autograd's path rounds it: g = sum_b x dh + reg * w, then
// eta * g, then w - eta * g (__fadd_rn / __fmul_rn / __fsub_rn keep nvcc
// from contracting them), with only the order of the B-term sum (an fmaf
// chain over b here, a GEMM's order there) differing.
//
// A dark device (live[i] == 0; live may be null for all devices up): its
// forward blocks write zeros to its rows of H and of the logits' shares and
// load nothing; its update blocks return before loading anything, so its
// parameters stay bitwise as they were and no non-finite value in its
// minibatch can reach them.
//
// Each launch takes a batch tile of B = 1..16 rows, rounded up to 4, 8 or
// 16 (BP) in the template; rows of X and dH past B are zeros in the
// registers and shared memory, and only the B real rows of H are written.
// A larger minibatch runs as tiles of 16 rows, one launch each
// (kernels/sim_nn_step.py).
//
// C interface (loaded with ctypes): each entry launches on the given stream,
// allocates nothing and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a batch tile outside 1..16, more devices than the grid takes, a hid
// that is not a multiple of 4 or a vector operand that is not 16-byte
// aligned.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 8;          // ring slots a thread (a power of two)
constexpr int kChunk = 128;         // rows of X staged at a time (forward)
constexpr int kRows = 196;          // rows of W1 a block updates (784 / 4)
constexpr int kV = 4;               // columns a thread: one float4
constexpr int kBatchTile = 16;      // BATCH_TILE in kernels/sim_nn_step.py
constexpr int kMaxGrid = 65535;     // grid.y and grid.z

__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// row k's copies have landed once at most kStages - 1 groups are pending
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void load_vec(float (&out)[kV], const float* src) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

// one row of the transposed X in shared memory: BP / 4 16-byte broadcasts
template <int BP>
__device__ __forceinline__ void load_row(float (&out)[BP], const float* src) {
  static_assert(BP % 4 == 0, "the batch tile is a multiple of 4");
#pragma unroll
  for (int b = 0; b < BP; b += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + b);
    out[b] = q.x; out[b + 1] = q.y; out[b + 2] = q.z; out[b + 3] = q.w;
  }
}

// rows r0 .. r0 + rows - 1 of X_i (B, m) into xs[kk][b], zeros past B and
// past rows, for nrows rows of the stage
template <int BP>
__device__ __forceinline__ void stage_x(float* xs, const float* xi, int B,
                                        int m, int r0, int rows, int nrows) {
  for (int e = threadIdx.x; e < nrows * BP; e += kThreads) {
    const int b = e / nrows, kk = e % nrows;
    xs[kk * BP + b] =
        (b < B && kk < rows) ? xi[static_cast<int64_t>(b) * m + r0 + kk] : 0.f;
  }
}

// part (B, C) of this block's tile: part[b][c] = sum over the block's
// columns j of hv[b][j] w2[j][c], hv the thread's BP x 4 values (zeros past
// B and on inactive threads), w2i its columns' rows of w2 (C each); a warp
// sums by shuffles, then thread b sums the warps' sums in warp order
template <int BP>
__device__ __forceinline__ void logits_share(const float (&hv)[BP][kV],
                                             const float* w2i, bool active,
                                             int B, int C, float* part) {
  __shared__ float red[kThreads / 32][BP];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int c = 0; c < C; ++c) {
    float q[BP];
#pragma unroll
    for (int b = 0; b < BP; ++b) q[b] = 0.f;
    if (active) {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const float w = __ldg(w2i + v * C + c);
#pragma unroll
        for (int b = 0; b < BP; ++b) q[b] = fmaf(hv[b][v], w, q[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        q[b] += __shfl_down_sync(0xffffffffu, q[b], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < BP; ++b) red[warp][b] = q[b];
    }
    __syncthreads();
    if (threadIdx.x < B) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w][threadIdx.x];
      part[threadIdx.x * C + c] = sum;
    }
    __syncthreads();
  }
}

template <int BP>
__global__ void __launch_bounds__(kThreads)
sim_nn_forward_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const uint8_t* __restrict__ live,
                      float* __restrict__ h, float* __restrict__ part, int B,
                      int m, int hid, int C) {
  __shared__ __align__(16) float xs[kChunk * BP];
  __shared__ __align__(16) float ring[kStages * kThreads * kV];
  const int i = blockIdx.y;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x) * kV;
  const bool active = col < hid;
  float* hi = h + static_cast<int64_t>(i) * B * hid + col;
  float* pi = part + (static_cast<int64_t>(i) * gridDim.x + blockIdx.x) * B * C;
  if (live != nullptr && live[i] == 0) {
    if (active) {
      for (int b = 0; b < B; ++b) {
        *reinterpret_cast<float4*>(hi + static_cast<int64_t>(b) * hid) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int e = threadIdx.x; e < B * C; e += kThreads) pi[e] = 0.f;
    return;
  }
  const float* wi = w1 + static_cast<int64_t>(i) * m * hid + col;
  const float* xi = x + static_cast<int64_t>(i) * B * m;
  float* slot = ring + threadIdx.x * kV;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < m && active) {
      copy_async(slot + s * kThreads * kV, wi + static_cast<int64_t>(s) * hid);
    }
    commit_async();
  }

  float acc[BP][kV];
#pragma unroll
  for (int b = 0; b < BP; ++b) {
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[b][v] = 0.f;
  }

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int rows = min(kChunk, m - k0);
    __syncthreads();                  // the last chunk's reads are done
    stage_x<BP>(xs, xi, B, m, k0, rows, kChunk);
    __syncthreads();
    for (int kk = 0; kk < rows; ++kk) {
      const int k = k0 + kk;
      const int kn = k + kStages - 1;
      if (kn < m && active) {
        copy_async(slot + (kn & (kStages - 1)) * kThreads * kV,
                   wi + static_cast<int64_t>(kn) * hid);
      }
      commit_async();
      wait_async();
      float w[kV], xb[BP];
      load_vec(w, slot + (k & (kStages - 1)) * kThreads * kV);
      load_row<BP>(xb, xs + kk * BP);
#pragma unroll
      for (int b = 0; b < BP; ++b) {
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[b][v] = fmaf(xb[b], w[v], acc[b][v]);
      }
    }
  }
  // H = relu(acc + b1) in place of acc (zeros past B and on inactive
  // threads), its B real rows stored
  float bias[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    bias[v] = active ? b1[static_cast<int64_t>(i) * hid + col + v] : 0.f;
  }
#pragma unroll
  for (int b = 0; b < BP; ++b) {
    const bool row = active && b < B;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const float s = __fadd_rn(acc[b][v], bias[v]);
      // relu, NaN kept as torch.relu keeps it
      acc[b][v] = row ? (s < 0.f ? 0.f : s) : 0.f;
    }
    if (!row) continue;
    *reinterpret_cast<float4*>(hi + static_cast<int64_t>(b) * hid) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  }
  logits_share<BP>(acc, w2 + (static_cast<int64_t>(i) * hid + col) * C,
                   active, B, C, pi);
}

template <int BP>
__global__ void __launch_bounds__(kThreads)
sim_nn_update_kernel(float* __restrict__ w1, const float* __restrict__ x,
                     const float* __restrict__ dh,
                     const uint8_t* __restrict__ live, float eta, float reg,
                     int B, int m, int hid) {
  __shared__ __align__(16) float xs[kRows * BP];
  __shared__ __align__(16) float ring[kStages * kThreads * kV];
  const int i = blockIdx.z;
  if (live != nullptr && live[i] == 0) return;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - r0);
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x) * kV;
  const bool active = col < hid;
  float* wi = w1 + (static_cast<int64_t>(i) * m + r0) * hid + col;
  float* slot = ring + threadIdx.x * kV;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < rows && active) {
      copy_async(slot + s * kThreads * kV, wi + static_cast<int64_t>(s) * hid);
    }
    commit_async();
  }

  stage_x<BP>(xs, x + static_cast<int64_t>(i) * B * m, B, m, r0, rows, rows);
  float d[BP][kV];
  const float* dhi = dh + static_cast<int64_t>(i) * B * hid + col;
#pragma unroll
  for (int b = 0; b < BP; ++b) {
    if (active && b < B) {
      load_vec(d[b], dhi + static_cast<int64_t>(b) * hid);
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) d[b][v] = 0.f;
    }
  }
  __syncthreads();

  for (int kk = 0; kk < rows; ++kk) {
    const int kn = kk + kStages - 1;
    if (kn < rows && active) {
      copy_async(slot + (kn & (kStages - 1)) * kThreads * kV,
                 wi + static_cast<int64_t>(kn) * hid);
    }
    commit_async();
    wait_async();
    if (!active) continue;
    float w[kV], xb[BP], out[kV];
    load_vec(w, slot + (kk & (kStages - 1)) * kThreads * kV);
    load_row<BP>(xb, xs + kk * BP);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      float g = 0.f;
#pragma unroll
      for (int b = 0; b < BP; ++b) g = fmaf(xb[b], d[b][v], g);
      g = __fadd_rn(g, __fmul_rn(reg, w[v]));
      out[v] = __fsub_rn(w[v], __fmul_rn(eta, g));
    }
    __stcs(reinterpret_cast<float4*>(wi + static_cast<int64_t>(kk) * hid),
           make_float4(out[0], out[1], out[2], out[3]));
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// calls launch.template run<BP>() for the batch tile B rounded up to 4, 8
// or 16
template <typename Launch>
int dispatch(int B, const Launch& launch) {
  static_assert(kBatchTile == 16, "the cases below cover 1..16");
  if (B <= 4) {
    launch.template run<4>();
  } else if (B <= 8) {
    launch.template run<8>();
  } else {
    launch.template run<16>();
  }
  return static_cast<int>(cudaGetLastError());
}

unsigned tiles(int hid) {
  const int per = kThreads * kV;
  return static_cast<unsigned>((hid + per - 1) / per);
}

struct Forward {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const uint8_t* live;
  float* h;
  float* part;
  int I, B, m, hid, C;
  cudaStream_t stream;
  template <int BP>
  void run() const {
    sim_nn_forward_kernel<BP><<<dim3(tiles(hid), I), kThreads, 0, stream>>>(
        x, w1, b1, w2, live, h, part, B, m, hid, C);
  }
};

struct Update {
  float* w1;
  const float* x;
  const float* dh;
  const uint8_t* live;
  float eta, reg;
  int I, B, m, hid;
  unsigned row_blocks;
  cudaStream_t stream;
  template <int BP>
  void run() const {
    sim_nn_update_kernel<BP>
        <<<dim3(tiles(hid), row_blocks, I), kThreads, 0, stream>>>(
            w1, x, dh, live, eta, reg, B, m, hid);
  }
};

// what both entries need: a batch tile of 1..16, a grid the card takes,
// hid a multiple of 4 and the float4 operands (W1 and H or dH) aligned
bool runnable(int I, int B, int m, int hid, const void* a, const void* b) {
  return B >= 1 && B <= kBatchTile && I >= 1 && I <= kMaxGrid && m >= 1 &&
         hid >= 1 && hid % kV == 0 && aligned(a) && aligned(b);
}

}  // namespace

// part: (I, tiles, B, C), tiles = ceil(hid / 512): each column tile's share
// of the logits H W2 (the caller sums the tiles and adds b2)
extern "C" int sim_nn_forward_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* live, void* h, void* part,
                                  int I, int B, int m, int hid, int C,
                                  void* stream) {
  if (!runnable(I, B, m, hid, w1, h) || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(B, Forward{
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const uint8_t*>(live), static_cast<float*>(h),
      static_cast<float*>(part), I, B, m, hid, C,
      static_cast<cudaStream_t>(stream)});
}

extern "C" int sim_nn_update_f32(void* w1, const void* x, const void* dh,
                                 const void* live, float eta, float reg,
                                 int I, int B, int m, int hid, void* stream) {
  const unsigned row_blocks = static_cast<unsigned>((m + kRows - 1) / kRows);
  if (!runnable(I, B, m, hid, w1, dh) || row_blocks > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(B, Update{
      static_cast<float*>(w1), static_cast<const float*>(x),
      static_cast<const float*>(dh), static_cast<const uint8_t*>(live), eta,
      reg, I, B, m, hid, row_blocks, static_cast<cudaStream_t>(stream)});
}
