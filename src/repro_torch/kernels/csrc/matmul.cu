// f32-accurate matrix product on Hopper: c = a @ b, a (M, K), b (K, N), all
// f32, row-major and contiguous. The 16-bit products (bf16 and f16 on the
// tensor cores, the same plan and summation order) follow it below.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py::_matmul_kernel
// (128^3 MXU tiles, a VMEM f32 accumulator carried along a sequential K grid
// axis) and the zero-padding copies of its wrapper (matmul/ops.py).
//
// Arithmetic: f32 fmaf on the CUDA cores. A 3xTF32 tensor-core version
// (operands split into rna-rounded tf32 hi + lo, three mma.sync m16n8k8 per
// 8 terms) was built first and failed the card check at K = 1: hi + lo keep
// 22 of an f32's 24 significand bits, so one product can miss by about
// 12 u |xy| against the 8 u |xy| that MATMUL_LIMIT (chip_smoke.py) allows
// there; it read 1.014 of the limit at (16x1)@(1x288) on an H100. So the sum
// is the f32 fused multiply-add, each term rounded once. What bounds it:
// operations for the large products (2*M*N*K FLOPs; 67 TFLOP/s on the CUDA
// cores of an H100 SXM at 700 W), bytes for the skinny ones.
//
// One summation order per entry, whatever M is. K is cut into segments of
// kSegLen terms; inside a segment the terms run in ascending order, each one
// fmaf into the segment's sum, which starts from 0; segment sums are added
// in ascending order into a running total (total = total + seg_s). Both
// paths keep that order, so a row of the product is bit-identical whether it
// is computed at m = 2 or among 2,050 rows, and two calls give the same
// bits. No atomics.
//
// Two paths, chosen by M alone:
// - tiled (M > kSkinnyRows): a block of 8 warps owns a 128x128 tile of c,
//   each thread an 8x8 register micro-tile (each warp 32x64); for n <= 64 a
//   128x64 tile of 8x4 micro-tiles, so that a narrow product (the GCN's
//   second layer, n = 40; the logistic regression, n = 1) computes fewer
//   dead columns. A 4-stage cp.async ring of 128x32 tiles of a and 32x128
//   (32x64) tiles of b (16-byte copies where the row length and base allow
//   it, 4-byte otherwise; the ragged edge zero-filled by the copy) feeds
//   them. Segment sums live in registers, the running totals in shared
//   memory (64 KB beside the 136 KB ring at 128 columns, 32 KB beside
//   104 KB at 64): they change once per 512 terms, and out
//   of registers they keep a thread at about 170 registers where both sets
//   in registers took all 255. A warp whose rows or columns lie wholly
//   outside c skips the arithmetic. A product of fewer than kSplitTiles
//   tiles (x_proj at n = 288: 48 tiles for 132 SMs) takes one block per
//   (tile, segment) instead and the ordered sum below.
// - skinny (M <= kSkinnyRows: decode projections, the head, the logistic
//   regression's d-theta): split-K. One block per (K-segment, 64-column
//   slab) reads its slab of b once through the same kind of ring, with
//   16-byte copies, and sums each entry over its segment in the same order.
// A split product writes its segments' sums into a workspace, and a second
// kernel adds the partials in ascending segment order; a product of one
// segment writes c directly as 0 + seg, which is what the ordered sum
// gives. Both grids go on the caller's stream under one entry point.
// Tensor cores at f32 accuracy (a three-way split, or wgmma with b restaged
// K-major) and a persistent schedule come later.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "launch_record.h"

namespace {

constexpr int kSegLen = 512;     // K-segment length L: the summation order
constexpr int kSkinnyRows = 16;  // M at most this takes the split-K path

// tiled path: 8 warps in a 4 x 2 grid; a thread's tile is 8 rows x CG
// groups of 4 columns, so a block's tile is 128 x 64*CG: CG = 2 in
// general, CG = 1 when n <= kNarrowN (fewer dead columns at n = 40 or 1)
constexpr int kTM = 128, kTThreads = 256, kTStages = 4, kTBK = 32;
constexpr int kTWarpsN = 2, kWM = 32;
constexpr int kNarrowN = 64;
constexpr int kLDA = kTBK + 4;  // padded row of an a tile: a warp's 4 rows in distinct banks
static_assert(kSegLen % kTBK == 0, "a stage never straddles two segments");

template <int CG>
struct Tile {
  static constexpr int kN = 64 * CG;  // the block's columns, and a b tile's row
  static constexpr int kWN = kN / kTWarpsN;
  static constexpr int kStageFloats = kTM * kLDA + kTBK * kN;
  // the ring, then each thread's running totals (thread-major, so that a
  // warp's accesses are consecutive)
  static constexpr int kSmemBytes = (kTStages * kStageFloats + kTM * kN) * 4;
};
// a tiled product with fewer tiles than this, and more than one segment,
// takes one block per (tile, segment) and the ordered sum of partials, as
// long as the partials fit kSplitMaxBytes
constexpr int kSplitTiles = 264;
constexpr long long kSplitMaxBytes = 256LL << 20;

// skinny path
constexpr int kSN = 64, kSThreads = 128, kSStages = 4, kSBK = 32;  // 64 columns x 2 row parities
constexpr int kLDAS = kSBK + 4;
constexpr int kLDBS = kSN;
constexpr int kSStageFloats = kSkinnyRows * kLDAS + kSBK * kLDBS;
static_assert(kSegLen % kSBK == 0, "a stage never straddles two segments");
constexpr int kSSmemBytes = kSStages * kSStageFloats * 4;

constexpr int kReduceThreads = 256;
constexpr int kReduceLongChain = 64;  // more segments than this: 32 lanes per entry

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix with
// `rows` x `cols` valid entries and leading dimension `ld` into a shared tile
// with leading dimension `lds`, zero-filling what lies outside. VEC: 16-byte
// copies (cols % 4 == 0 and a 16-byte aligned base), else 4-byte copies.
template <bool VEC, int R, int C, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* __restrict__ src,
                                          long long ld, int r0, int c0, int rows, int cols,
                                          int tid) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int PER_ROW = C / W;
  static_assert((R * PER_ROW) % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < (R * PER_ROW) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / PER_ROW, cc = (i % PER_ROW) * W;
    const int gr = r0 + r, gc = c0 + cc;
    const bool in = gr < rows && gc < cols;
    const float* p = in ? src + static_cast<long long>(gr) * ld + gc : src;
    if (VEC) {
      cp_async16(dst + r * lds + cc, p, in ? 4 * min(4, cols - gc) : 0);
    } else {
      cp_async4(dst + r * lds + cc, p, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ int live(int extent) { return extent > 0; }

// One K-term of a thread's micro-tile: acc[i][j] = fma(a[i], b[j], acc[i][j]),
// b[j] from the float4 groups at br, br + 32, ... Every entry of every path
// sums through fmaf in ascending K from 0 within a segment: the same
// operation, the same order.
template <int CG>
__device__ __forceinline__ void fma_tile(float (&acc)[8][4 * CG], const float (&a)[8],
                                         const float* br) {
  float b[4 * CG];
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(br + 32 * g);
    b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CG; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// grid (row tiles, column tiles, z). split = 0: z = 1, each block walks all
// of K, keeps the running total and writes c. split = 1: block z sums
// segment z alone and writes it as partial z of the workspace `out`.
template <int CG, bool VA, bool VB>
__global__ void __launch_bounds__(kTThreads, 1)
matmul_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int m, int n, int k, int split) {
  using T = Tile<CG>;
  extern __shared__ __align__(16) float smem[];
  float* tots = smem + kTStages * T::kStageFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTM, col0 = blockIdx.y * T::kN;
  // warp (wm, wn) owns rows wm + ly + 4i and columns wn + lx*4 + {0..3}
  // + 32g: the 4 rows a warp reads at once fall in distinct banks, and its
  // 8 column groups at each g are one 128-byte line of a b row.
  const int wm = (warp / kTWarpsN) * kWM, wn = (warp % kTWarpsN) * T::kWN;
  const int ly = lane / 8, lx = lane % 8;
  const bool busy = live(m - row0 - wm) && live(n - col0 - wn);  // warp-uniform
  constexpr int kStagesPerSeg = kSegLen / kTBK;
  constexpr int kCols = 4 * CG;
  const int kt0 = split ? blockIdx.z * kStagesPerSeg : 0;
  const int kt1 = split ? min(kt0 + kStagesPerSeg, (k + kTBK - 1) / kTBK) : (k + kTBK - 1) / kTBK;
  const int nk = kt1 - kt0;

  float seg[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) seg[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < 8 * kCols; ++e) tots[e * kTThreads + tid] = 0.f;

  auto load = [&](int it) {
    float* st = smem + (it % kTStages) * T::kStageFloats;
    const int k0 = (kt0 + it) * kTBK;
    load_tile<VA, kTM, kTBK, kTThreads>(st, kLDA, a, k, row0, k0, m, k, tid);
    load_tile<VB, kTBK, T::kN, kTThreads>(st + kTM * kLDA, T::kN, b, n, k0, col0, k, n, tid);
  };
#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kTStages - 2>();
    __syncthreads();
    if (it + kTStages - 1 < nk) load(it + kTStages - 1);
    cp_async_commit();
    const float* st = smem + (it % kTStages) * T::kStageFloats;
    const float* as = st + (wm + ly) * kLDA;
    const float* bs = st + kTM * kLDA + wn + lx * 4;
    const int terms = min(kTBK, k - (kt0 + it) * kTBK);  // the last stage may hold fewer
    if (busy && terms == kTBK) {
#pragma unroll
      for (int kk = 0; kk < kTBK; kk += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(as + 4 * i * kLDA + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = q == 0 ? a4[i].x : q == 1 ? a4[i].y : q == 2 ? a4[i].z : a4[i].w;
          fma_tile<CG>(seg, av, bs + (kk + q) * T::kN);
        }
      }
    } else if (busy) {
      for (int kk = 0; kk < terms; ++kk) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = as[4 * i * kLDA + kk];
        fma_tile<CG>(seg, av, bs + kk * T::kN);
      }
    }
    if (!split && ((kt0 + it + 1) % kStagesPerSeg == 0 || it + 1 == nk)) {  // a segment ends
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float& t = tots[(i * kCols + j) * kTThreads + tid];
          t = __fadd_rn(t, seg[i][j]);
          seg[i][j] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  if (!busy) return;
  float* dst = split ? out + static_cast<long long>(blockIdx.z) * m * n : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + wm + ly + 4 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int cc = col0 + wn + lx * 4 + (j & 3) + (j >> 2) * 32;
      if (cc < n)
        dst[static_cast<long long>(r) * n + cc] =
            split ? seg[i][j] : tots[(i * kCols + j) * kTThreads + tid];
    }
  }
}

// grid (segments, column slabs). out: the workspace, partial s of entry
// (r, col) at s*m*n + r*n + col; or c itself when `direct` (one segment).
// Thread t sums column t % 64 of the slab for rows t / 64, + 2, + 4, ...
template <bool VA, bool VB>
__global__ void __launch_bounds__(kSThreads)
matmul_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int m, int n, int k, int direct) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int col = tid % kSN, r0 = tid / kSN;  // r0 is warp-uniform
  const int kbeg = s * kSegLen;
  const int nk = (min(k - kbeg, kSegLen) + kSBK - 1) / kSBK;
  constexpr int kRows = kSkinnyRows * kSN / kSThreads;  // rows per thread

  float seg[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) seg[i] = 0.f;

  auto load = [&](int kt) {
    float* st = smem + (kt % kSStages) * kSStageFloats;
    const int k0 = kbeg + kt * kSBK;
    load_tile<VA, kSkinnyRows, kSBK, kSThreads>(st, kLDAS, a, k, 0, k0, m, k, tid);
    load_tile<VB, kSBK, kSN, kSThreads>(st + kSkinnyRows * kLDAS, kLDBS, b, n, k0,
                                       blockIdx.y * kSN, k, n, tid);
  };
#pragma unroll
  for (int i = 0; i < kSStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kSStages - 2>();
    __syncthreads();
    if (kt + kSStages - 1 < nk) load(kt + kSStages - 1);
    cp_async_commit();
    const float* st = smem + (kt % kSStages) * kSStageFloats;
    const float* as = st + r0 * kLDAS;
    const float* bs = st + kSkinnyRows * kLDAS + col;
    const int terms = min(kSBK, k - kbeg - kt * kSBK);
    if (terms == kSBK) {
#pragma unroll
      for (int kk = 0; kk < kSBK; kk += 4) {
        const float b4[4] = {bs[kk * kLDBS], bs[(kk + 1) * kLDBS], bs[(kk + 2) * kLDBS],
                             bs[(kk + 3) * kLDBS]};
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (r0 + 2 * i < m) {
            const float4 a4 = *reinterpret_cast<const float4*>(as + 2 * i * kLDAS + kk);
            seg[i] = fmaf(a4.x, b4[0], seg[i]);
            seg[i] = fmaf(a4.y, b4[1], seg[i]);
            seg[i] = fmaf(a4.z, b4[2], seg[i]);
            seg[i] = fmaf(a4.w, b4[3], seg[i]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < terms; ++kk) {
        const float bv = bs[kk * kLDBS];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (r0 + 2 * i < m) seg[i] = fmaf(as[2 * i * kLDAS + kk], bv, seg[i]);
      }
    }
  }
  cp_async_wait<0>();

  const int cc = blockIdx.y * kSN + col;
  if (cc >= n) return;
  float* dst = direct ? out : out + static_cast<long long>(s) * m * n;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + 2 * i;
    if (r < m) dst[static_cast<long long>(r) * n + cc] = direct ? __fadd_rn(0.f, seg[i]) : seg[i];
  }
}

// c[i] = ((0 + part[0][i]) + part[1][i]) + ... in ascending segment order:
// the tiled path's running total, term for term. nseg = 0 writes zeros.
// The adds of an entry are one dependent chain; what can run ahead are the
// loads. G lanes serve one entry: lane j loads segments j, j + G, ..., P
// rounds ahead, and every lane of the group adds the G values of a round in
// order, taking them by shuffle. G = 1 for a few segments; G = 32 for long
// chains (d-theta has 2,048), where one lane's loads in flight would leave
// the chain waiting on memory.
__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half to_out(float x, __half*) { return __float2half_rn(x); }

// OutT: float (the f32 product) or a 16-bit type, each entry rounded once
// from the f32 total at the store.
template <int G, typename OutT>
__global__ void __launch_bounds__(kReduceThreads)
matmul_ordered_sum_kernel(const float* __restrict__ part, OutT* __restrict__ c,
                          long long mn, int nseg) {
  constexpr int P = 4;
  const long long t = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const long long i = t / G;
  const int j = static_cast<int>(t % G);
  if (i >= mn) return;  // whole groups leave together
  const float* p = part + i;
  auto load = [&](int s) { return s < nseg ? __ldg(p + s * mn) : 0.f; };
  float v[P];
#pragma unroll
  for (int r = 0; r < P; ++r) v[r] = load(r * G + j);
  float tot = 0.f;
  for (int base = 0; base < nseg; base += P * G) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      float x[G];  // the round's values, taken before the chain needs them
#pragma unroll
      for (int q = 0; q < G; ++q) x[q] = G == 1 ? v[r] : __shfl_sync(0xffffffffu, v[r], q, G);
      v[r] = load(base + (r + P) * G + j);
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (base + r * G + q < nseg) tot = __fadd_rn(tot, x[q]);
    }
  }
  if (j == 0) c[i] = to_out(tot, c);
}

// Raise a kernel's dynamic shared-memory cap once per device.
cudaError_t allow_smem(const void* fn, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? (1u << dev) : 0u;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && bit) done.fetch_or(bit);
  return err;
}

template <int CG, bool VA, bool VB>
cudaError_t launch_tiled(const float* a, const float* b, float* out, int m, int n, int k,
                         int split, dim3 grid, cudaStream_t st) {
  constexpr int bytes = Tile<CG>::kSmemBytes;
  static std::atomic<unsigned> done{0};
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&matmul_tiled_kernel<CG, VA, VB>), bytes, done);
  if (err != cudaSuccess) return err;
  repro::record_launch(repro::kMatmulTiled, Tile<CG>::kN, grid, dim3(kTThreads));
  matmul_tiled_kernel<CG, VA, VB><<<grid, kTThreads, bytes, st>>>(a, b, out, m, n, k, split);
  return cudaGetLastError();
}

template <bool VA, bool VB>
cudaError_t launch_product(bool tiled, const float* a, const float* b, float* out, int m, int n,
                           int k, int split, dim3 grid, cudaStream_t st) {
  if (!tiled) {
    repro::record_launch(repro::kMatmulSkinny, 0, grid, dim3(kSThreads));
    matmul_skinny_kernel<VA, VB><<<grid, kSThreads, kSSmemBytes, st>>>(a, b, out, m, n, k, !split);
    return cudaGetLastError();
  }
  return n <= kNarrowN ? launch_tiled<1, VA, VB>(a, b, out, m, n, k, split, grid, st)
                       : launch_tiled<2, VA, VB>(a, b, out, m, n, k, split, grid, st);
}

// What one call launches, for every dtype (matmul/ops.py::plan mirrors it):
// the path, the product's grid, whether it is split over its K-segments.
struct Plan {
  bool tiled, split;
  int nseg;
  long long mn;
  dim3 grid;
};

// The plan of an (m, k) @ (k, n) product, m and n > 0, whose tiled path
// splits over K-segments below `split_tiles` tiles; false where a grid would
// pass CUDA's limits.
bool make_plan(int m, int n, int k, int split_tiles, Plan& p) {
  p.nseg = (k + kSegLen - 1) / kSegLen;
  p.mn = static_cast<long long>(m) * n;
  p.tiled = m > kSkinnyRows;
  if (p.tiled) {
    const long long gx = (static_cast<long long>(m) + kTM - 1) / kTM;
    const int tile_n = n <= kNarrowN ? Tile<1>::kN : Tile<2>::kN;
    const long long gy = (static_cast<long long>(n) + tile_n - 1) / tile_n;
    if (gy > 65535LL) return false;
    p.split = p.nseg > 1 && gx * gy < split_tiles && p.nseg <= 65535 &&
              p.nseg * p.mn * 4 <= kSplitMaxBytes;
    p.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), p.split ? p.nseg : 1);
  } else {
    const long long slabs = (static_cast<long long>(n) + kSN - 1) / kSN;
    if (slabs > 65535LL) return false;
    p.split = p.nseg != 1;  // one segment writes c directly; none, the sum writes zeros
    p.grid = dim3(p.nseg, static_cast<unsigned>(slabs));
  }
  return true;
}

// The ordered sum of a split product's partials into c, recorded as `code`.
template <typename OutT>
cudaError_t launch_reduce(const float* part, OutT* c, long long mn, int nseg, int code,
                          cudaStream_t st) {
  const int lanes = nseg > kReduceLongChain ? 32 : 1;
  const long long blocks = (mn * lanes + kReduceThreads - 1) / kReduceThreads;
  repro::record_launch(code, lanes, dim3(static_cast<unsigned>(blocks)), dim3(kReduceThreads));
  if (lanes == 32)
    matmul_ordered_sum_kernel<32, OutT><<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
        part, c, mn, nseg);
  else
    matmul_ordered_sum_kernel<1, OutT><<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
        part, c, mn, nseg);
  return cudaGetLastError();
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n); f32, row-major, contiguous. workspace:
// ceil(k / 512) * m * n f32 partials when the product is split over its
// K-segments (m <= 16 and k > 512; or fewer than kSplitTiles tiles, k > 512
// and partials within kSplitMaxBytes), else unused. Returns the first CUDA
// error of its launches.
extern "C" int repro_matmul_f32(const void* a_, const void* b_, void* c_, void* workspace,
                                long long workspace_bytes, int m, int n, int k,
                                void* stream) {
  repro::record_begin();
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const float* a = static_cast<const float*>(a_);
  const float* b = static_cast<const float*>(b_);
  float* c = static_cast<float*>(c_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool va = k % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  const bool vb = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  Plan p;
  if (!make_plan(m, n, k, kSplitTiles, p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.split && p.nseg > 0 && (workspace == nullptr || workspace_bytes < p.nseg * p.mn * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = p.split ? static_cast<float*>(workspace) : c;
  const bool tiled = p.tiled, split = p.split;
  const dim3 grid = p.grid;
  cudaError_t err = cudaSuccess;
  if (tiled || p.nseg > 0) {
    err = va ? (vb ? launch_product<true, true>(tiled, a, b, out, m, n, k, split, grid, st)
                   : launch_product<true, false>(tiled, a, b, out, m, n, k, split, grid, st))
             : (vb ? launch_product<false, true>(tiled, a, b, out, m, n, k, split, grid, st)
                   : launch_product<false, false>(tiled, a, b, out, m, n, k, split, grid, st));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (split)
    err = launch_reduce(static_cast<const float*>(workspace), c, p.mn, p.nseg, repro::kMatmulReduce,
                        st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// 16-bit products on the tensor cores: c = a @ b, a (M, K), b (K, N), c
// (M, N), all bf16 or all f16, row-major and contiguous.
//
// This is the TPU kernel's own case: _matmul_kernel reads bf16 tiles, sums
// in f32 on the MXU and rounds once to out_dtype = x.dtype. A product of two
// 16-bit values is exact in f32, so the 3xTF32 trouble above does not arise.
//
// Summation order, the f32 kernel's in k16 steps: K is cut into kSegLen =
// 512 segments; inside a segment the k16 steps run in ascending order into
// an f32 sum that starts at 0 (the order inside one step is the tensor
// core's own); segment sums are added in ascending order into an f32 total,
// in registers, or through the f32 workspace and the ordered sum when the
// product is split; each entry is rounded once to the output type at the
// store. A step's entry (i, j) depends on row i of a, column j of b and its
// accumulator alone; every kernel runs the same k16 steps (none starting at
// or past K; a step's terms past K are zeros), a segment's first from 0 (a
// zeroed accumulator in the mma.sync kernels, scale-d = 0 in the wgmma
// one); and a wgmma k16 step rounds as an mma.sync m16n8k16 step does
// (chip_smoke.py 29.1 holds rows computed by both to the same bits). So a
// row of the product is bit-identical whatever M is.
//
// Three kernels, chosen by M and by what TMA can describe:
// - tiled, wgmma (M > kSkinnyRows; K and N multiples of 8 and both bases
//   16-byte aligned, as at every product of the LM zoo): one block of three
//   warpgroups per 128 x 128 tile of c (128 x 64 for n <= 64). A producer
//   warpgroup gives its registers up (setmaxnreg) and one of its threads
//   keeps a kWStages-deep ring full with TMA loads: a stage is a 128 x 64
//   tile of a (K-major) and a 64 x 128 tile of b as two 64-column boxes (b
//   is stored (K, N), which wgmma reads as its N-major B operand, so it is
//   not restaged), both in the 128-byte swizzle, each stage guarded by a
//   full and an empty mbarrier; TMA's zero fill masks the ragged edges. Two
//   consumer warpgroups each own 64 rows and issue wgmma.mma_async m64n128k16
//   (m64n64k16) from shared memory, a stage's group left in flight while the
//   next one's is issued; at a segment's end a consumer waits for its
//   groups, adds the segment sum into its running total (64 + 64 f32
//   registers a thread), and opens the next segment with scale-d = 0, so
//   that only wgmma writes the segment's registers (an instruction that
//   touched them while a group is in flight would make ptxas wait for it).
//   A warpgroup whose rows lie wholly outside c idles. The tensor maps are
//   encoded on the host for each call (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint) and passed as __grid_constant__
//   parameters. What holds it below cuBLAS: a block reaches ~0.6-0.7 of an
//   SM's tensor-core rate, and 128 x 128 tiles quantize into waves (224
//   tiles on 132 SMs take two); the fold's registers (the running total
//   beside the segment's sum) rule out a wider tile. Pairing row tiles in
//   2-block clusters that multicast b (a quarter less L2 traffic) was no
//   faster on the card, so the blocks stay single.
// - tiled, mma.sync (M > kSkinnyRows, operands TMA cannot describe: a row
//   length not a multiple of 8 values or a base not 16-byte aligned, which
//   no zoo site has): a block of 8 warps (4 x 2) owns the same tile, each
//   warp 32 x 64 (two m16 tiles by eight n8 tiles; 32 x 32 for n <= 64),
//   fed by a 4-stage cp.async ring of 128 x 32 tiles of a and 32 x 128 (32
//   x 64) tiles of b, rows padded by 8 values so that ldmatrix's 8 rows fall
//   in distinct banks. It is kept rather than a wgmma kernel fed by the
//   threads' own copies because the two instructions round alike (above).
// - skinny (M <= kSkinnyRows: decode, the head at decode): split-K, one
//   block of 4 warps per (K-segment, 64-column slab), one m16 row tile whose
//   rows past M are zero-filled, each warp 16 columns (two n8 tiles) of
//   mma.sync. It is bound by the bytes of b, which it reads once.
// Copies in the mma.sync kernels: 16 bytes (8 values) where a row's length
// and the base allow it, the ragged edge zero-filled by cp.async; otherwise
// 4-byte units loaded by the threads (two values, or one and one at a
// 2-byte aligned address) and stored to shared memory, zero outside.
//
// The plan is the f32 entry point's paths and tiles with a split rule of its
// own (kSplitTiles16). Splitting a tiled product of T tiles over its S = K /
// 512 segments spreads it over T * S blocks, but writes and reads back S * m
// * n f32 partials: 8 * S * m * n bytes. At the tensor cores' R = 989
// TFLOP/s over 132 SMs and the memory's B = 3.35 TB/s, T <= 132 tiles of TM
// x TN take one wave unsplit, t = S t_seg with t_seg = 2 TM TN 512 * 132 /
// (e R) a pipelined segment at a share e of the rate; split, T S blocks of
// beta t_seg each over 132 SMs (a block that sums one segment alone also
// fills and drains its ring and stores 64 KB of f32) plus the partials' 8 S
// T TM TN / B = 0.0175 e T t. So a split pays while T (beta / 132 + 0.0175
// e) < 1. At beta = 1, e = 1 (the arithmetic alone) that is below 40 tiles;
// at the card's beta ~ 3.5 and e ~ 0.7, below 26. chip_smoke.py phase 8
// times both schedules at (512 x 7168) @ (7168 x n) as the tiles grow: the
// split pays at 24 tiles and loses at 32, so kSplitTiles16 = 28. The f32
// rule (264 tiles) was set for the CUDA cores, whose arithmetic is 15 times
// slower against the same partials.
// What bounds it: operations for the large products (2*M*N*K FLOPs; 989
// TFLOP/s dense bf16/f16 on an H100 SXM), bytes for the skinny ones.

namespace {

constexpr int kHTM = 128, kHThreads = 256, kHStages = 4, kHBK = 32;
constexpr int kHLDA = kHBK + 8;  // a tile's padded row (80 bytes)
static_assert(kSegLen % kHBK == 0, "a stage never straddles two segments");

template <int NT>  // n8 tiles per warp: 8 (128 columns a block) or 4 (64)
struct HTile {
  static constexpr int kN = 16 * NT;       // the block's columns (2 warps across)
  static constexpr int kLDB = kN + 8;      // a b tile's padded row
  static constexpr int kStageElems = kHTM * kHLDA + kHBK * kLDB;
  static constexpr int kSmemBytes = kHStages * kStageElems * 2;
};

constexpr int kHSN = 64, kHSThreads = 128;  // skinny: 4 warps x 16 columns
constexpr int kHSLDA = kHBK + 8, kHSLDB = kHSN + 8;
constexpr int kHSStageElems = kSkinnyRows * kHSLDA + kHBK * kHSLDB;
constexpr int kHSSmemBytes = kHStages * kHSStageElems * 2;

template <typename T>
struct MmaOp;

template <>
struct MmaOp<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct MmaOp<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a's 16 x 16 fragment: lane l names row l % 16, columns (l / 16) * 8 on
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// b's fragments of two n8 tiles from a k-major tile: lane l names k row
// (l % 8) + ((l / 8) % 2) * 8, columns (l / 16) * 8 on; r[0], r[1] are the
// first tile's (k 0-7, 8-15), r[2], r[3] the second's
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major 16-bit matrix
// (`rows` x `cols` valid, leading dimension `ld`) into a shared tile of
// leading dimension `lds`, zero outside. VEC: 16-byte cp.async (cols % 8 ==
// 0 and a 16-byte aligned base); else 4-byte units by the threads.
template <bool VEC, int R, int C, int THREADS>
__device__ __forceinline__ void load_tile16(unsigned short* dst, int lds,
                                            const unsigned short* __restrict__ src, long long ld,
                                            int r0, int c0, int rows, int cols, int tid) {
  constexpr int W = VEC ? 8 : 2;
  constexpr int PER_ROW = C / W;
  constexpr int UNITS = R * PER_ROW;
#pragma unroll
  for (int it = 0; it < (UNITS + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (UNITS % THREADS != 0 && i >= UNITS) break;
    const int r = i / PER_ROW, cc = (i % PER_ROW) * W;
    const int gr = r0 + r, gc = c0 + cc;
    const bool in = gr < rows && gc < cols;
    const unsigned short* p = in ? src + static_cast<long long>(gr) * ld + gc : src;
    if (VEC) {
      cp_async16(dst + r * lds + cc, p, in ? 2 * min(8, cols - gc) : 0);
    } else {
      unsigned v = 0;
      if (in) {
        if (gc + 1 < cols && (reinterpret_cast<std::uintptr_t>(p) & 3) == 0) {
          v = __ldg(reinterpret_cast<const unsigned*>(p));
        } else {
          v = __ldg(p);
          if (gc + 1 < cols) v |= static_cast<unsigned>(__ldg(p + 1)) << 16;
        }
      }
      *reinterpret_cast<unsigned*>(dst + r * lds + cc) = v;
    }
  }
}

// grid (row tiles, column tiles, z). split = 0: z = 1, each block walks all
// of K, keeps the running totals and writes c (16-bit). split = 1: block z
// sums segment z alone and writes it as f32 partial z of `ws`.
template <typename T, int NT, bool VA, bool VB>
__global__ void __launch_bounds__(kHThreads, 1)
matmul_tiled_mma_kernel(const T* __restrict__ a_, const T* __restrict__ b_, T* __restrict__ c,
                        float* __restrict__ ws, int m, int n, int k, int split) {
  using Tl = HTile<NT>;
  extern __shared__ __align__(16) unsigned short hsmem[];
  const unsigned short* a = reinterpret_cast<const unsigned short*>(a_);
  const unsigned short* b = reinterpret_cast<const unsigned short*>(b_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kHTM, col0 = blockIdx.y * Tl::kN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (8 * NT);
  const bool busy = live(m - row0 - wm) && live(n - col0 - wn);  // warp-uniform
  constexpr int kStagesPerSeg = kSegLen / kHBK;
  const int nkt = (k + kHBK - 1) / kHBK;
  const int kt0 = split ? blockIdx.z * kStagesPerSeg : 0;
  const int kt1 = split ? min(kt0 + kStagesPerSeg, nkt) : nkt;
  const int nk = kt1 - kt0;

  float seg[2][NT][4], tot[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) seg[i][j][e] = tot[i][j][e] = 0.f;

  auto load = [&](int it) {
    unsigned short* st = hsmem + (it % kHStages) * Tl::kStageElems;
    const int k0 = (kt0 + it) * kHBK;
    load_tile16<VA, kHTM, kHBK, kHThreads>(st, kHLDA, a, k, row0, k0, m, k, tid);
    load_tile16<VB, kHBK, Tl::kN, kHThreads>(st + kHTM * kHLDA, Tl::kLDB, b, n, k0, col0, k, n,
                                             tid);
  };
#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();
    if (it + kHStages - 1 < nk) load(it + kHStages - 1);
    cp_async_commit();
    const unsigned short* st = hsmem + (it % kHStages) * Tl::kStageElems;
    const unsigned short* as = st + (wm + (lane & 15)) * kHLDA + (lane >> 4) * 8;
    const unsigned short* bs =
        st + kHTM * kHLDA + ((lane & 7) + ((lane >> 3) & 1) * 8) * Tl::kLDB + wn + (lane >> 4) * 8;
    const int k0 = (kt0 + it) * kHBK;
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < kHBK; kk += 16) {
        if (k0 + kk >= k) break;  // no k16 step past K: the skinny path runs none either
        unsigned af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], as + i * 16 * kHLDA + kk);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, bs + kk * Tl::kLDB + jj * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            MmaOp<T>::run(seg[i][2 * jj], af[i], bf[0], bf[1]);
            MmaOp<T>::run(seg[i][2 * jj + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    if (!split && ((kt0 + it + 1) % kStagesPerSeg == 0 || it + 1 == nk)) {  // a segment ends
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] = __fadd_rn(tot[i][j][e], seg[i][j][e]);
            seg[i][j][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  if (!busy) return;
  const int g = lane >> 2, t4 = lane & 3;
  float* part = split ? ws + static_cast<long long>(blockIdx.z) * m * n : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm + i * 16 + g + (e >> 1) * 8;
        const int cc = col0 + wn + j * 8 + 2 * t4 + (e & 1);
        if (r < m && cc < n) {
          const long long at = static_cast<long long>(r) * n + cc;
          if (split)
            part[at] = seg[i][j][e];
          else
            c[at] = to_out(tot[i][j][e], c);
        }
      }
}

// grid (segments, 64-column slabs): one m16 row tile (rows past m zero),
// warp w sums columns 16w..16w+15 of the slab over the block's segment.
// direct (one segment): c = 0 + seg, rounded; else f32 partial s of `ws`.
template <typename T, bool VA, bool VB>
__global__ void __launch_bounds__(kHSThreads)
matmul_skinny_mma_kernel(const T* __restrict__ a_, const T* __restrict__ b_, T* __restrict__ c,
                         float* __restrict__ ws, int m, int n, int k, int direct) {
  extern __shared__ __align__(16) unsigned short hsmem[];
  const unsigned short* a = reinterpret_cast<const unsigned short*>(a_);
  const unsigned short* b = reinterpret_cast<const unsigned short*>(b_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int col0 = blockIdx.y * kHSN, wn = warp * 16;
  const bool busy = live(n - col0 - wn);  // warp-uniform
  const int kbeg = s * kSegLen;
  const int nk = (min(k - kbeg, kSegLen) + kHBK - 1) / kHBK;

  float seg[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) seg[j][e] = 0.f;

  auto load = [&](int kt) {
    unsigned short* st = hsmem + (kt % kHStages) * kHSStageElems;
    const int k0 = kbeg + kt * kHBK;
    load_tile16<VA, kSkinnyRows, kHBK, kHSThreads>(st, kHSLDA, a, k, 0, k0, m, k, tid);
    load_tile16<VB, kHBK, kHSN, kHSThreads>(st + kSkinnyRows * kHSLDA, kHSLDB, b, n, k0, col0, k,
                                            n, tid);
  };
#pragma unroll
  for (int i = 0; i < kHStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();
    if (kt + kHStages - 1 < nk) load(kt + kHStages - 1);
    cp_async_commit();
    const unsigned short* st = hsmem + (kt % kHStages) * kHSStageElems;
    const unsigned short* as = st + (lane & 15) * kHSLDA + (lane >> 4) * 8;
    const unsigned short* bs = st + kSkinnyRows * kHSLDA +
                               ((lane & 7) + ((lane >> 3) & 1) * 8) * kHSLDB + wn + (lane >> 4) * 8;
    const int k0 = kbeg + kt * kHBK;
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < kHBK; kk += 16) {
        if (k0 + kk >= k) break;
        unsigned af[4], bf[4];
        ldmatrix_x4(af, as + kk);
        ldmatrix_x4_trans(bf, bs + kk * kHSLDB);
        MmaOp<T>::run(seg[0], af, bf[0], bf[1]);
        MmaOp<T>::run(seg[1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!busy) return;
  const int g = lane >> 2, t4 = lane & 3;
  float* part = direct ? nullptr : ws + static_cast<long long>(s) * m * n;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8;
      const int cc = col0 + wn + j * 8 + 2 * t4 + (e & 1);
      if (r < m && cc < n) {
        const long long at = static_cast<long long>(r) * n + cc;
        if (direct)
          c[at] = to_out(__fadd_rn(0.f, seg[j][e]), c);
        else
          part[at] = seg[j][e];
      }
    }
}

// ---- the tiled wgmma kernel ----------------------------------------------

constexpr int kWTM = 128;        // a block's rows: two consumer warpgroups of 64
constexpr int kWBK = 64;         // terms a stage: one 128-byte swizzled row of a
constexpr int kWStages = 6;      // the ring's depth
constexpr int kWThreads = 384;   // the producer warpgroup, then two consumers
constexpr int kWBox = 64;        // a TMA box's columns (128 bytes, the swizzle's span)
constexpr int kWProducerRegs = 40, kWConsumerRegs = 232;  // setmaxnreg: 128 * 40 + 256 * 232 <= 64 K
static_assert(kSegLen % kWBK == 0, "a stage never straddles two segments");

template <int BN>  // the block's columns: 128, or 64 for n <= 64
struct WTile {
  static constexpr int kABytes = kWTM * kWBK * 2;   // 16 KB
  static constexpr int kBBytes = kWBK * BN * 2;     // BN / 64 boxes of 8 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, its 2 * kWStages mbarriers, and slack to align the ring to
  // the swizzle's 1,024-byte period
  static constexpr int kSmemBytes = kWStages * kStageBytes + 16 * kWStages + 1024;
};

#define REPRO_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define REPRO_D16(i) REPRO_D4(i), REPRO_D4(i + 4), REPRO_D4(i + 8), REPRO_D4(i + 12)
#define REPRO_R32                                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "  \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_R64                                                                                 \
  REPRO_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// d (64 x BN, f32) = a (64 x 16, K-major) * b (16 x BN, N-major) + (acc ?
// d : 0): scale-a and scale-b 1, a not transposed, b transposed
#define REPRO_WGMMA(SHAPE, TY, REGS, DA, DB, ACC)                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " ACC ", 0;\nwgmma.mma_async.sync.aligned." SHAPE \
  ".f32." TY "." TY " {" REGS "}, " DA ", " DB ", p, 1, 1, 0, 1;\n}\n"

template <typename T, int BN>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], unsigned long long da,
                                             unsigned long long db, int acc) {
    asm volatile(REPRO_WGMMA("m64n128k16", "bf16", REPRO_R64, "%64", "%65", "%66")
                 : REPRO_D16(0), REPRO_D16(16), REPRO_D16(32), REPRO_D16(48)
                 : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], unsigned long long da,
                                             unsigned long long db, int acc) {
    asm volatile(REPRO_WGMMA("m64n128k16", "f16", REPRO_R64, "%64", "%65", "%66")
                 : REPRO_D16(0), REPRO_D16(16), REPRO_D16(32), REPRO_D16(48)
                 : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], unsigned long long da,
                                             unsigned long long db, int acc) {
    asm volatile(REPRO_WGMMA("m64n64k16", "bf16", REPRO_R32, "%32", "%33", "%34")
                 : REPRO_D16(0), REPRO_D16(16)
                 : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<__half, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], unsigned long long da,
                                             unsigned long long db, int acc) {
    asm volatile(REPRO_WGMMA("m64n64k16", "f16", REPRO_R32, "%32", "%33", "%34")
                 : REPRO_D16(0), REPRO_D16(16)
                 : "l"(da), "l"(db), "r"(acc));
  }
};

#undef REPRO_WGMMA
#undef REPRO_R64
#undef REPRO_R32
#undef REPRO_D16
#undef REPRO_D4

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one box of a 2-D tensor map, at (column c0, row c1), into shared memory
// at dst; its bytes complete a transaction on the mbarrier bar
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units), layout 1.
// a (K-major): rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO); a
// k16 step is 32 bytes further along the row. b (N-major): k-rows of 128
// bytes (64 columns), 8-row groups 1,024 bytes apart (SBO), the next 64
// columns a box (8 KB) further (LBO); a k16 step is 16 rows further.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits (their asm does not name them).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// grid (row tiles, column tiles, z). split = 0: z = 1, each block walks all
// of K and writes c (16-bit) from its running totals. split = 1: block z
// sums segment z alone and writes it as f32 partial z of ws.
template <typename T, int BN>
__global__ void __launch_bounds__(kWThreads, 1)
matmul_tiled_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, T* __restrict__ c,
                          float* __restrict__ ws, int m, int n, int k, int split) {
  using Tl = WTile<BN>;
  constexpr int kRegs = BN / 2;  // accumulator registers a thread (m64nBN: 64 x BN / 128)
  extern __shared__ unsigned char wsmem[];
  const unsigned ring = (smem_addr(wsmem) + 1023u) & ~1023u;
  const unsigned full0 = ring + kWStages * Tl::kStageBytes, empty0 = full0 + 8 * kWStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = blockIdx.x * kWTM, col0 = blockIdx.y * BN;
  constexpr int kStagesPerSeg = kSegLen / kWBK;
  const int nkt = (k + kWBK - 1) / kWBK;
  const int kt0 = split ? blockIdx.z * kStagesPerSeg : 0;
  const int kt1 = split ? min(kt0 + kStagesPerSeg, nkt) : nkt;
  const int nk = kt1 - kt0;
  const int consumers = m - row0 > 64 ? 2 : 1;  // the second's 64 rows may lie below c

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs));
    if (t == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kWStages;
        mbar_wait(empty0 + 8 * s, ((it / kWStages) & 1) ^ 1);  // a fresh ring passes at once
        mbar_expect_tx(full0 + 8 * s, Tl::kStageBytes);
        const unsigned st = ring + s * Tl::kStageBytes;
        const int k0 = (kt0 + it) * kWBK;
        tma_load(st, &ta, k0, row0, full0 + 8 * s);
#pragma unroll
        for (int j = 0; j < BN / kWBox; ++j)
          tma_load(st + Tl::kABytes + j * kWBK * kWBox * 2, &tb, col0 + j * kWBox, k0, full0 + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs));
  const int cw = wg - 1;  // rows [row0 + 64 cw, + 64)
  if (cw >= consumers) return;
  // seg is written by the wgmma steps alone (a segment's first step does
  // not read it: the sum starts at 0), so no other instruction touches it
  // while a group is in flight
  float seg[kRegs], tot[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) seg[i] = tot[i] = 0.f;
  int pending = -1;  // the stage whose wgmma group may still read shared memory
  for (int it = 0; it < nk; ++it) {
    const int s = it % kWStages;
    mbar_wait(full0 + 8 * s, (it / kWStages) & 1);
    const unsigned st = ring + s * Tl::kStageBytes;
    const unsigned long long da = smem_desc(st + cw * 64 * 128, 16, 1024);
    const unsigned long long db = smem_desc(st + Tl::kABytes, kWBK * kWBox * 2, 1024);
    const int k0 = (kt0 + it) * kWBK;
    const int acc = (kt0 + it) % kStagesPerSeg != 0;  // 0: the stage opens a segment
    pin(seg);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // da + 2: 32 bytes further along a's rows; db + 128: 16 rows of b on
    if (k - k0 >= kWBK) {
#pragma unroll
      for (int j = 0; j < kWBK / 16; ++j) Wgmma<T, BN>::run(seg, da + 2 * j, db + 128 * j, acc | j);
    } else {  // K's last stage: no k16 step starts at or past K
#pragma unroll
      for (int j = 0; j < kWBK / 16; ++j)
        if (16 * j < k - k0) Wgmma<T, BN>::run(seg, da + 2 * j, db + 128 * j, acc | j);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if ((kt0 + it + 1) % kStagesPerSeg == 0 || it + 1 == nk) {  // a segment ends
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(seg);
      if (t == 0) {
        if (pending >= 0) mbar_arrive(empty0 + 8 * pending);
        mbar_arrive(empty0 + 8 * s);
      }
      pending = -1;
      if (!split) {
#pragma unroll
        for (int i = 0; i < kRegs; ++i) tot[i] = __fadd_rn(tot[i], seg[i]);
      }
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin(seg);
      if (t == 0 && pending >= 0) mbar_arrive(empty0 + 8 * pending);
      pending = s;
    }
  }

  // entry 4q + e of a thread: row 16 w + g + 8 (e >> 1), column 8 q + 2 t4 +
  // (e & 1) of its warpgroup's 64 x BN (the mma m16n8 layout, per warp)
  const int w = t / 32, g = (t % 32) / 4, t4 = t % 4;
  float* part = split ? ws + static_cast<long long>(blockIdx.z) * m * n : nullptr;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const int r = row0 + cw * 64 + w * 16 + g + ((i >> 1) & 1) * 8;
    const int cc = col0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
    if (r < m && cc < n) {
      const long long at = static_cast<long long>(r) * n + cc;
      if (split)
        part[at] = seg[i];
      else
        c[at] = to_out(tot[i], c);
    }
  }
}

// ---- launches and the 16-bit entry points --------------------------------

template <typename T, int NT, bool VA, bool VB>
cudaError_t launch_tiled_mma(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                             int split, dim3 grid, cudaStream_t st) {
  constexpr int bytes = HTile<NT>::kSmemBytes;
  static std::atomic<unsigned> done{0};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&matmul_tiled_mma_kernel<T, NT, VA, VB>), bytes, done);
  if (err != cudaSuccess) return err;
  repro::record_launch(repro::kMatmulTiledMma, HTile<NT>::kN, grid, dim3(kHThreads));
  matmul_tiled_mma_kernel<T, NT, VA, VB><<<grid, kHThreads, bytes, st>>>(a, b, c, ws, m, n, k,
                                                                         split);
  return cudaGetLastError();
}

template <typename T, bool VA, bool VB>
cudaError_t launch_product_mma(bool tiled, const T* a, const T* b, T* c, float* ws, int m, int n,
                               int k, int split, dim3 grid, cudaStream_t st) {
  if (!tiled) {
    repro::record_launch(repro::kMatmulSkinnyMma, 0, grid, dim3(kHSThreads));
    matmul_skinny_mma_kernel<T, VA, VB><<<grid, kHSThreads, kHSSmemBytes, st>>>(a, b, c, ws, m, n,
                                                                                k, !split);
    return cudaGetLastError();
  }
  return n <= kNarrowN ? launch_tiled_mma<T, 4, VA, VB>(a, b, c, ws, m, n, k, split, grid, st)
                       : launch_tiled_mma<T, 8, VA, VB>(a, b, c, ws, m, n, k, split, grid, st);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up once (null
// where the installed CUDA library lacks it: the call then fails).
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType kTmaType = std::is_same<T, __half>::value
                                             ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A row-major (rows, cols) 16-bit matrix as boxes of box_rows x kWBox in the
// 128-byte swizzle, zero outside; false if cuTensorMapEncodeTiled refuses it.
template <typename T>
bool encode_map(CUtensorMap* map, const T* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {kWBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, kTmaType<T>, 2, const_cast<T*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BN>
cudaError_t launch_tiled_wgmma(const T* a, const T* b, T* c, float* ws, int m, int n, int k,
                               int split, dim3 grid, cudaStream_t st) {
  constexpr int bytes = WTile<BN>::kSmemBytes;
  static std::atomic<unsigned> done{0};
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&matmul_tiled_wgmma_kernel<T, BN>), bytes, done);
  if (err != cudaSuccess) return err;
  CUtensorMap ta{}, tb{};  // K = 0 loads nothing
  if (k > 0 && !(encode_map(&ta, a, m, k, kWTM) && encode_map(&tb, b, k, n, kWBK)))
    return cudaErrorInvalidValue;
  repro::record_launch(repro::kMatmulTiledWgmma, BN, grid, dim3(kWThreads));
  matmul_tiled_wgmma_kernel<T, BN><<<grid, kWThreads, bytes, st>>>(ta, tb, c, ws, m, n, k, split);
  return cudaGetLastError();
}

constexpr int kSplitTiles16 = 28;  // the 16-bit plan's split rule (the note above)
// the plan's tiles (kTM rows; Tile<1>::kN, Tile<2>::kN columns) are every
// 16-bit kernel's, and the skinny slab is kSN
static_assert(kHTM == kTM && kWTM == kTM && HTile<4>::kN == Tile<1>::kN &&
                  HTile<8>::kN == Tile<2>::kN && Tile<1>::kN == 64 && Tile<2>::kN == 128 &&
                  kHSN == kSN,
              "the 16-bit kernels take the plan's tiles");

// The 16-bit entry points' body: the 16-bit plan (the f32 entry point's
// paths, grids and workspace of f32 partials; kSplitTiles16), the wgmma
// kernel where TMA describes the operands, else the mma.sync kernels.
// force_split: -1 follows the plan; 0 or 1 sets a tiled product's split
// (the split rule's check on the card), where the plan could take either.
template <typename T>
int matmul16(const void* a_, const void* b_, void* c_, void* workspace, long long workspace_bytes,
             int m, int n, int k, int force_split, void* stream) {
  repro::record_begin();
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* c = static_cast<T*>(c_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool va = k % 8 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  const bool vb = n % 8 == 0 && reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  Plan p;
  if (!make_plan(m, n, k, kSplitTiles16, p)) return static_cast<int>(cudaErrorInvalidValue);
  if (force_split >= 0) {
    Plan both;
    if (!p.tiled || !make_plan(m, n, k, 1 << 30, both) || !both.split)
      return static_cast<int>(cudaErrorInvalidValue);
    p.split = force_split != 0;
    p.grid.z = p.split ? p.nseg : 1;
  }
  if (p.split && p.nseg > 0 && (workspace == nullptr || workspace_bytes < p.nseg * p.mn * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(workspace);
  const bool tiled = p.tiled, split = p.split;
  const dim3 grid = p.grid;
  cudaError_t err = cudaSuccess;
  if (tiled && (k == 0 || (va && vb))) {
    err = n <= kNarrowN ? launch_tiled_wgmma<T, 64>(a, b, c, ws, m, n, k, split, grid, st)
                        : launch_tiled_wgmma<T, 128>(a, b, c, ws, m, n, k, split, grid, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (tiled || p.nseg > 0) {
    err = va ? (vb ? launch_product_mma<T, true, true>(tiled, a, b, c, ws, m, n, k, split, grid, st)
                   : launch_product_mma<T, true, false>(tiled, a, b, c, ws, m, n, k, split, grid,
                                                        st))
             : (vb ? launch_product_mma<T, false, true>(tiled, a, b, c, ws, m, n, k, split, grid,
                                                        st)
                   : launch_product_mma<T, false, false>(tiled, a, b, c, ws, m, n, k, split, grid,
                                                         st));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (split) err = launch_reduce(ws, c, p.mn, p.nseg, repro::kMatmulReduce16, st);
  return static_cast<int>(err);
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n); bf16 (f16), row-major, contiguous. The
// workspace: ceil(k / 512) * m * n f32 partials when the 16-bit plan splits
// the product (m <= 16 and k > 512; or fewer than kSplitTiles16 tiles, k >
// 512 and partials within kSplitMaxBytes), else unused. Returns the first
// CUDA error of its launches.
extern "C" int repro_matmul_bf16(const void* a, const void* b, void* c, void* workspace,
                                 long long workspace_bytes, int m, int n, int k, void* stream) {
  return matmul16<__nv_bfloat16>(a, b, c, workspace, workspace_bytes, m, n, k, -1, stream);
}

extern "C" int repro_matmul_f16(const void* a, const void* b, void* c, void* workspace,
                                long long workspace_bytes, int m, int n, int k, void* stream) {
  return matmul16<__half>(a, b, c, workspace, workspace_bytes, m, n, k, -1, stream);
}

// repro_matmul_bf16 with a tiled product's split set (split 0 or 1) rather
// than planned, for a shape whose plan could take either (m > 16, more than
// one segment, partials within kSplitMaxBytes): what checks the split rule
// on the card. The workspace must hold the split's partials.
extern "C" int repro_matmul_bf16_split(const void* a, const void* b, void* c, void* workspace,
                                       long long workspace_bytes, int m, int n, int k, int split,
                                       void* stream) {
  return matmul16<__nv_bfloat16>(a, b, c, workspace, workspace_bytes, m, n, k, split != 0,
                                 stream);
}
