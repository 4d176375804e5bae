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

#include <algorithm>
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
// Four kernels, chosen by M and by what TMA can describe:
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
// - skinny, clusters (M <= kSkinnyRows: decode, the head at decode; K and
//   N multiples of 8 on 16-byte aligned bases, as at every zoo site): one
//   launch and no workspace. The grid is (C, slabs), one thread-block
//   cluster of C blocks along K per column slab of SN = 64 or 128 columns
//   (C <= 8, the portable size, and <= the S = ceil(K / 512) segments; set
//   at launch with cudaLaunchAttributeClusterDimension). Block r owns the
//   segments [r S / C, (r + 1) S / C) (runs differ by one at most) and
//   streams them through a ring of kKStages TMA stages of 64 terms: a's m16
//   box (2 KB; TMA zero-fills rows past M and reads no bytes for them), SN / 64
//   64-column boxes of b, in the 128-byte swizzle, each stage guarded by a
//   CTA-scoped full and empty mbarrier (the cluster stays out of the ring:
//   cluster-scope arrives per stage were several times slower on the card),
//   one producer thread issuing the loads; TMA's zero fill masks ragged K
//   and N. Four consumer warps each own SN / 4 columns and run mma.sync
//   m16n8k16 on fragments that ldmatrix (.trans for b) reads with the
//   swizzle's XOR in the address, so that the eight rows of a 128-byte box
//   fall in distinct banks; a stage's fragments are all loaded before its
//   k16 steps run. mma.sync rather than wgmma: a wgmma step is 64 rows, 48
//   or more of them zero here, and the kernel is bound by b's bytes, not by
//   the tensor cores; the two round alike (above), and a wgmma consumer
//   (A from registers, rows past M zero) was 1-4 % slower at the decode
//   sites on the card and 38 % slower streaming alone. A
//   segment's sum starts from 0 and runs over its k16 steps in ascending
//   order in registers; at its end rows < M are stored apart in the block's
//   shared memory (run x M x SN f32). After one cluster barrier
//   (barrier.cluster arrive.release / wait.acquire) each rank folds its
//   share of the slab's 8-column groups over all S segments, ascending from
//   0, with __fadd_rn, reading each sum from the owning block's shared
//   memory (mapa + ld.shared::cluster, kKFoldAhead loads ahead of the adds),
//   rounds each entry once and stores c; a second cluster barrier keeps
//   every block's shared memory alive until the cluster's last read. That
//   is the ordered sum's arithmetic term for term, so the bits are the
//   split path's. Its plan is below the tiled kernels' note.
// - skinny, mma.sync (M <= kSkinnyRows, operands TMA cannot describe, or a
//   K so deep that no cluster's runs of sums fit shared memory): split-K,
//   one block of 4 warps per (K-segment, 64-column slab), one m16 row tile
//   whose rows past M are zero-filled, each warp 16 columns (two n8 tiles)
//   of mma.sync, its partials summed in order by a second grid. Both skinny
//   kernels are bound by the bytes of b, which they read once.
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
//
// The skinny cluster kernel's plan (make_skinny_plan; ops.py::skinny_plan
// mirrors it). A skinny product reads b once, K x N x 2 bytes at the
// memory's 3.35 TB/s, so what matters is how the card's SMs share the
// stream. Three things were measured on the card (H100 SXM at 700 W, every
// (cluster, slab, stages) of deepseek-coder-33b's decode sites, CUDA
// graphs): (1) a block's rate is capped near 38 GB/s at SN = 128 and 42
// GB/s at 64 by its consumers (about twice that with the k16 steps taken
// out), so the stream needs blocks on nearly every SM; (2) a block has a
// fixed cost of about 5 us (the launch's share, the first load's latency,
// the fold and its two cluster barriers), so more blocks than SMs, in
// waves of short runs, lose (q/o at C = 7, SN = 64, 784 blocks: 0.060 ms
// against 0.040 at C = 2, SN = 128, 112 blocks); (3) a deeper ring is
// slower, not faster (gate/up at C = 1, SN = 128: 0.096 ms at 3 stages,
// 0.101 at 4, 0.126 at 6), so kKStages = 3 (48 KB of b in flight at SN =
// 128). So the rule aims at one block an SM: the wide slab (longer rows
// for the memory) unless even 8-block clusters of wide slabs stay short
// of 132 blocks, which takes the narrow one (k/v, N = 1,024: 16 slabs of
// 64, C = 8, 128 blocks); then C = the cluster that brings slabs x C
// nearest to 132 (q/o and down, 56 wide slabs: C = 2, 112 blocks; gate/up
// and the head, 150 and 252: C = 1), raised until a block's run of sums
// fits its shared memory (at most 8 and the segments; past that the
// mma.sync split-K path takes the product). At every decode site the rule
// picked the sweep's fastest (cluster, slab) or one within 3 % of it;
// chip_smoke.py phase 8 repeats the sweep.

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

// ---- the skinny cluster kernel --------------------------------------------

constexpr int kKBK = 64;                   // terms a stage: one 128-byte swizzled row of a
constexpr int kKWarps = 4;                 // consumer warps; a producer warp beside them
constexpr int kKThreads = 32 * (kKWarps + 1);
constexpr int kKMaxCluster = 8;            // the portable cluster size
constexpr int kKSlabWide = 128, kKSlabNarrow = 64;
constexpr int kKStages = 3;                // the ring's depth (the plan's note)
constexpr int kKABytes = kSkinnyRows * kKBK * 2;  // a's m16 box: 2 KB
constexpr int kKFoldAhead = 8;             // the fold's loads in flight ahead of its adds
// the card the plan is set for: an H100's SMs and the shared memory a block
// may take
constexpr int kSMs = 132;
constexpr int kBlockSmemMax = 232448;
static_assert(kSegLen % kKBK == 0, "a stage never straddles two segments");
static_assert(kKBK == kWBox, "a's box is one swizzle span of terms");

__host__ __device__ constexpr int skinny_stage_bytes(int slab) { return kKABytes + kKBK * slab * 2; }

// A block's dynamic shared memory: the ring, its 2 * kKStages mbarriers,
// the sums of its longest run of segments (ceil(nseg / cluster) x m x slab
// f32), and slack to align the ring to the swizzle's 1,024-byte period.
long long skinny_smem(int m, int nseg, int cluster, int slab) {
  const long long run = (nseg + cluster - 1) / cluster;
  return static_cast<long long>(kKStages) * (skinny_stage_bytes(slab) + 16) + run * m * slab * 4 +
         1024;
}

__device__ __forceinline__ void ldmatrix_x4_at(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans_at(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Every thread of every block of the cluster: what each wrote to shared
// memory before is seen by the others' reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// f32 at the shared-memory address `addr` of block `rank` of the cluster
__device__ __forceinline__ float ld_cluster(unsigned addr, int rank) {
  unsigned remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// the byte offset of 16-byte chunk `chunk` of row `row` of a 128-byte
// swizzled box: the chunk index XOR the row's index mod 8
__device__ __forceinline__ unsigned swz(int row, int chunk) {
  return static_cast<unsigned>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// grid (C, slabs), cluster (C, 1, 1): block r = blockIdx.x of the cluster
// for slab blockIdx.y sums its run of segments, then folds its share of
// the slab's columns over all of them (the note above).
template <typename T, int SN>
__global__ void __launch_bounds__(kKThreads, 1)
matmul_skinny_tma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, T* __restrict__ c, int m, int n,
                         int k) {
  constexpr int S = kKStages;
  constexpr int kStage = skinny_stage_bytes(SN);
  constexpr int kWCols = SN / kKWarps;  // a consumer warp's columns: 32 or 16
  constexpr int NT = kWCols / 8;        // its n8 tiles
  extern __shared__ unsigned char ksmem[];
  const unsigned ring = (smem_addr(ksmem) + 1023u) & ~1023u;
  const unsigned full0 = ring + S * kStage, empty0 = full0 + 8 * S;
  const unsigned sums = empty0 + 8 * S;  // f32 [local segment][row < m][SN]
  const int C = static_cast<int>(gridDim.x), r = static_cast<int>(blockIdx.x);
  const int nseg = (k + kSegLen - 1) / kSegLen;
  const int s0 = r * nseg / C;
  const int kbeg = s0 * kSegLen, kend = min((r + 1) * nseg / C * kSegLen, k);
  const int nk = (kend - kbeg + kKBK - 1) / kKBK;
  const int col0 = static_cast<int>(blockIdx.y) * SN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 32 * kKWarps && nk > 0) {  // the descriptors' fetch ahead of the first loads
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&ta)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&tb)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kKWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kKWarps) {  // the producer
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % S;
        mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);  // a fresh ring passes at once
        mbar_expect_tx(full0 + 8 * s, kStage);
        const unsigned st = ring + s * kStage;
        const int k0 = kbeg + it * kKBK;
        tma_load(st, &ta, k0, 0, full0 + 8 * s);
#pragma unroll
        for (int j = 0; j < SN / kWBox; ++j)
          tma_load(st + kKABytes + j * kKBK * kWBox * 2, &tb, col0 + j * kWBox, k0, full0 + 8 * s);
      }
    }
    __syncwarp();
  } else {
    const int wc = warp * kWCols;  // the warp's first column of the slab
    const bool busy = col0 + wc < n;  // warp-uniform
    const int arow = lane & 15;                               // a: row of ldmatrix's lane
    const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;     // b: k row of .trans's lane
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const unsigned st = ring + s * kStage;
      const int k0 = kbeg + it * kKBK;
      if (busy) {
        // the stage's fragments first, all loads in flight at once, then
        // its k16 steps in ascending order (a step waits for its own loads
        // alone); no k16 step at or past K
        const int steps = min(kKBK / 16, (k - k0 + 15) / 16);
        unsigned af[kKBK / 16][4], bf[kKBK / 16][NT / 2][4];
#pragma unroll
        for (int j = 0; j < kKBK / 16; ++j) {
          if (j < steps) {
            ldmatrix_x4_at(af[j], st + swz(arow, 2 * j + (lane >> 4)));
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
              const int col = wc + 16 * p;
              const unsigned box = st + kKABytes + (col / kWBox) * (kKBK * kWBox * 2);
              ldmatrix_x4_trans_at(bf[j][p],
                                   box + swz(16 * j + brow, (col % kWBox) / 8 + (lane >> 4)));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kKBK / 16; ++j) {
          if (j < steps) {
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
              MmaOp<T>::run(acc[2 * p], af[j], bf[j][p][0], bf[j][p][1]);
              MmaOp<T>::run(acc[2 * p + 1], af[j], bf[j][p][2], bf[j][p][3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if ((k0 + kKBK) % kSegLen == 0 || it + 1 == nk) {  // a segment ends
        const int ls = k0 / kSegLen - s0;
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = g + (e >> 1) * 8;
            if (busy && row < m) {
              const unsigned at = sums + ((ls * m + row) * SN + wc + 8 * j + 2 * t4 + (e & 1)) * 4;
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at), "f"(acc[j][e]) : "memory");
            }
            acc[j][e] = 0.f;
          }
      }
    }
  }

  cluster_sync();  // every run's segment sums are in its block's shared memory
  // rank r folds the slab's 8-column groups [r G / C, (r + 1) G / C)
  constexpr int G = SN / 8;
  const int cbeg = 8 * (r * G / C), width = 8 * ((r + 1) * G / C) - cbeg;
  for (int e = threadIdx.x; e < m * width; e += kKThreads) {
    const int row = e / width, col = cbeg + e % width;
    if (col0 + col >= n) continue;
    float tot = 0.f;
    int o = 0;  // the rank whose run holds segment s
    for (int sb = 0; sb < nseg; sb += kKFoldAhead) {
      float v[kKFoldAhead];
#pragma unroll
      for (int q = 0; q < kKFoldAhead; ++q) {
        const int s = sb + q;
        v[q] = 0.f;
        if (s < nseg) {
          while ((o + 1) * nseg / C <= s) ++o;
          const int ls = s - o * nseg / C;
          v[q] = ld_cluster(sums + ((ls * m + row) * SN + col) * 4, o);
        }
      }
#pragma unroll
      for (int q = 0; q < kKFoldAhead; ++q)
        if (sb + q < nseg) tot = __fadd_rn(tot, v[q]);
    }
    c[static_cast<long long>(row) * n + col0 + col] = to_out(tot, c);
  }
  cluster_sync();  // no block leaves while another may read its sums
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

// The skinny cluster kernel's plan (ops.py::skinny_plan mirrors it).
struct SkinnyPlan {
  int cluster, slab, slabs;
  long long smem;
};

// The (slab, cluster) the rule of the note above takes for an (m, k) @ (k,
// n) product, m <= kSkinnyRows, or the forced ones (0: planned); false when
// it fits neither a block's shared memory nor CUDA's grid.
bool make_skinny_plan(int m, int n, int k, int force_cluster, int force_slab, SkinnyPlan& sp) {
  const int nseg = (k + kSegLen - 1) / kSegLen;
  const int cmax = std::max(1, std::min(kKMaxCluster, nseg));
  const long long wide = (static_cast<long long>(n) + kKSlabWide - 1) / kKSlabWide;
  // the wide slab, unless even the largest cluster leaves its slabs short
  // of one block an SM
  const int slab = force_slab != 0 ? force_slab
                                   : (wide * kKMaxCluster >= kSMs ? kKSlabWide : kKSlabNarrow);
  const long long slabs = (static_cast<long long>(n) + slab - 1) / slab;
  if (slabs > 65535LL) return false;
  // the cluster that brings slabs x C nearest to one block an SM, raised
  // until a block's sums fit
  int c = force_cluster != 0
              ? force_cluster
              : static_cast<int>(std::max(1LL, std::min<long long>(cmax, (2 * kSMs + slabs) / (2 * slabs))));
  for (; c <= cmax; ++c) {
    const long long smem = skinny_smem(m, nseg, c, slab);
    if (smem <= kBlockSmemMax) {
      sp = SkinnyPlan{c, slab, static_cast<int>(slabs), smem};
      return true;
    }
    if (force_cluster != 0) break;
  }
  return false;
}

// Raise a kernel's dynamic shared-memory cap to a block's most and ask for
// the largest shared-memory carveout, once per device.
cudaError_t allow_smem_max(const void* fn, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? (1u << dev) : 0u;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && bit) done.fetch_or(bit);
  return err;
}

// The cluster launch of a skinny plan on stream st (attr: its one attribute).
void skinny_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, const SkinnyPlan& sp,
                   cudaStream_t st) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(sp.cluster, sp.slabs);
  cfg.blockDim = dim3(kKThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(sp.smem);
  cfg.stream = st;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = sp.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T, int SN>
cudaError_t launch_skinny_tma(const T* a, const T* b, T* c, int m, int n, int k,
                              const SkinnyPlan& sp, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&matmul_skinny_tma_kernel<T, SN>);
  static std::atomic<unsigned> done{0};
  cudaError_t err = allow_smem_max(fn, done);
  if (err != cudaSuccess) return err;
  CUtensorMap ta{}, tb{};  // K = 0 loads nothing
  if (k > 0 && !(encode_map(&ta, a, m, k, kSkinnyRows) && encode_map(&tb, b, k, n, kKBK)))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  skinny_config(cfg, attr, sp, st);
  repro::record_launch(repro::kMatmulSkinnyTma, SN, cfg.gridDim, cfg.blockDim, dim3(sp.cluster));
  void* args[] = {&ta, &tb, &c, &m, &n, &k};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The skinny cluster kernel's launch of a plan, on the plan's slab.
template <typename T>
cudaError_t launch_skinny(const T* a, const T* b, T* c, int m, int n, int k, const SkinnyPlan& sp,
                          cudaStream_t st) {
  return sp.slab == kKSlabWide ? launch_skinny_tma<T, kKSlabWide>(a, b, c, m, n, k, sp, st)
                               : launch_skinny_tma<T, kKSlabNarrow>(a, b, c, m, n, k, sp, st);
}

// The 16-bit entry points' body: the 16-bit plan (the f32 entry point's
// paths, grids and workspace of f32 partials; kSplitTiles16), the skinny
// cluster kernel where TMA describes a skinny product's operands (or K = 0)
// and its plan fits, the wgmma kernel where TMA describes a tiled one's,
// else the mma.sync kernels. force_split: -1 follows the plan; 0 or 1 sets
// a tiled product's split (the split rule's check on the card), where the
// plan could take either.
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
  SkinnyPlan sp;
  if (m <= kSkinnyRows && (k == 0 || (va && vb)) && make_skinny_plan(m, n, k, 0, 0, sp)) {
    if (force_split >= 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_skinny(a, b, c, m, n, k, sp, st));
  }
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
// the product (m <= 16 and k > 512 on operands TMA cannot describe, or a K
// too deep for the cluster kernel; or fewer than kSplitTiles16 tiles, k >
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
  return matmul16<__nv_bfloat16>(a, b, c, workspace, workspace_bytes, m, n, k, split != 0, stream);
}

// repro_matmul_bf16 on the skinny cluster kernel with its cluster (1 to 8,
// at most the segments) and slab (64 or 128 columns) set rather than
// planned, for a product that kernel takes (m <= 16, operands TMA
// describes): what checks the skinny rule on the card. No workspace.
extern "C" int repro_matmul_bf16_skinny(const void* a, const void* b, void* c, int m, int n, int k,
                                        int cluster, int slab, void* stream) {
  repro::record_begin();
  SkinnyPlan sp;
  if (m < 1 || m > kSkinnyRows || n < 1 || k < 0 || k % 8 != 0 || n % 8 != 0 ||
      reinterpret_cast<std::uintptr_t>(a) % 16 != 0 || reinterpret_cast<std::uintptr_t>(b) % 16 != 0 ||
      cluster < 1 || (slab != kKSlabWide && slab != kKSlabNarrow) ||
      !make_skinny_plan(m, n, k, cluster, slab, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_skinny(static_cast<const __nv_bfloat16*>(a),
                                        static_cast<const __nv_bfloat16*>(b),
                                        static_cast<__nv_bfloat16*>(c), m, n, k, sp,
                                        static_cast<cudaStream_t>(stream)));
}

// The skinny plan of an (m, k) @ (k, n) 16-bit product on aligned bases,
// with its cluster and slab forced where not 0: out[0..4] = cluster, slab,
// slabs, shared-memory bytes a block, and cudaOccupancyMaxActiveClusters
// for that launch on the current device. Returns a CUDA error, or
// cudaErrorInvalidValue where the cluster kernel does not take the product.
extern "C" int repro_matmul16_skinny_plan(int m, int n, int k, int cluster, int slab,
                                          long long* out) {
  SkinnyPlan sp;
  if (m < 1 || m > kSkinnyRows || n < 1 || k < 0 || (k % 8) != 0 || (n % 8) != 0 ||
      !make_skinny_plan(m, n, k, cluster, slab, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = sp.slab == kKSlabWide
                       ? reinterpret_cast<const void*>(&matmul_skinny_tma_kernel<__nv_bfloat16, kKSlabWide>)
                       : reinterpret_cast<const void*>(&matmul_skinny_tma_kernel<__nv_bfloat16, kKSlabNarrow>);
  static std::atomic<unsigned> done_wide{0}, done_narrow{0};
  cudaError_t err = allow_smem_max(fn, sp.slab == kKSlabWide ? done_wide : done_narrow);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  skinny_config(cfg, attr, sp, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = sp.cluster, out[1] = sp.slab, out[2] = sp.slabs, out[3] = sp.smem, out[4] = clusters;
  return 0;
}
