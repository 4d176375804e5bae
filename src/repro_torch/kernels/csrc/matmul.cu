// f32-accurate matrix product on Hopper: c = a @ b, a (M, K), b (K, N), all
// f32, row-major and contiguous.
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

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
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
template <int G>
__global__ void __launch_bounds__(kReduceThreads)
matmul_ordered_sum_kernel(const float* __restrict__ part, float* __restrict__ c,
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
  if (j == 0) c[i] = tot;
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
  matmul_tiled_kernel<CG, VA, VB><<<grid, kTThreads, bytes, st>>>(a, b, out, m, n, k, split);
  return cudaGetLastError();
}

template <bool VA, bool VB>
cudaError_t launch_product(bool tiled, const float* a, const float* b, float* out, int m, int n,
                           int k, int split, dim3 grid, cudaStream_t st) {
  if (!tiled) {
    matmul_skinny_kernel<VA, VB><<<grid, kSThreads, kSSmemBytes, st>>>(a, b, out, m, n, k, !split);
    return cudaGetLastError();
  }
  return n <= kNarrowN ? launch_tiled<1, VA, VB>(a, b, out, m, n, k, split, grid, st)
                       : launch_tiled<2, VA, VB>(a, b, out, m, n, k, split, grid, st);
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
  if (m < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const float* a = static_cast<const float*>(a_);
  const float* b = static_cast<const float*>(b_);
  float* c = static_cast<float*>(c_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool va = k % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  const bool vb = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  const int nseg = (k + kSegLen - 1) / kSegLen;
  const long long mn = static_cast<long long>(m) * n;
  const bool tiled = m > kSkinnyRows;
  bool split;
  dim3 grid;
  if (tiled) {
    const long long gx = (static_cast<long long>(m) + kTM - 1) / kTM;
    const int tile_n = n <= kNarrowN ? Tile<1>::kN : Tile<2>::kN;
    const long long gy = (static_cast<long long>(n) + tile_n - 1) / tile_n;
    if (gy > 65535LL) return static_cast<int>(cudaErrorInvalidValue);
    split = nseg > 1 && gx * gy < kSplitTiles && nseg <= 65535 &&
            nseg * mn * 4 <= kSplitMaxBytes;
    grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), split ? nseg : 1);
  } else {
    const long long slabs = (static_cast<long long>(n) + kSN - 1) / kSN;
    if (slabs > 65535LL) return static_cast<int>(cudaErrorInvalidValue);
    split = nseg != 1;  // one segment writes c directly; none, the sum writes zeros
    grid = dim3(nseg, static_cast<unsigned>(slabs));
  }
  if (split && nseg > 0 && (workspace == nullptr || workspace_bytes < nseg * mn * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = split ? static_cast<float*>(workspace) : c;
  cudaError_t err = cudaSuccess;
  if (tiled || nseg > 0) {
    err = va ? (vb ? launch_product<true, true>(tiled, a, b, out, m, n, k, split, grid, st)
                   : launch_product<true, false>(tiled, a, b, out, m, n, k, split, grid, st))
             : (vb ? launch_product<false, true>(tiled, a, b, out, m, n, k, split, grid, st)
                   : launch_product<false, false>(tiled, a, b, out, m, n, k, split, grid, st));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (split) {
    const int lanes = nseg > kReduceLongChain ? 32 : 1;
    const long long blocks = (mn * lanes + kReduceThreads - 1) / kReduceThreads;
    const float* part = static_cast<const float*>(workspace);
    if (lanes == 32)
      matmul_ordered_sum_kernel<32><<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
          part, c, mn, nseg);
    else
      matmul_ordered_sum_kernel<1><<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
          part, c, mn, nseg);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
