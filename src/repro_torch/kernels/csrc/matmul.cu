// Tiled f32 matrix product on Hopper: c = a @ b, a (M, K), b (K, N), all
// row-major and contiguous.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py::_matmul_kernel
// (128^3 MXU tiles, a VMEM f32 accumulator carried along a sequential K grid
// axis) and the zero-padding copies of its wrapper (matmul/ops.py).
//
// What bounds it: operations for the forward products (2*M*N*K f32 FLOPs on
// the CUDA cores, 67 TFLOP/s on an H100 SXM at 700 W), bytes for the skinny
// ones. The sum is in full f32 on the CUDA cores, never TF32, so it holds the
// atol 1e-5 bar of docs/kernels.md; the tensor cores are a later step.
//
// Design: a block of 256 threads owns a 64x64 tile of c and walks K in steps
// of 16, staging a 64x16 tile of a (stored transposed) and a 16x64 tile of b
// in shared memory; each thread keeps a 4x4 micro-tile of c in registers
// (rows ty + 16*i, columns tx + 16*j, so shared reads of b and global writes
// of c are contiguous across a warp). Ragged M, N and K are masked at the
// loads and at the store instead of padding copies. Only the output tiles run
// in parallel: a product with few output tiles and a long K (the weight
// gradients, K = number of nodes) keeps few SMs busy. Split-K and wgmma come
// later.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int mm = i / kBK, kk = i % kBK;
      const int gm = row0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < m && gk < k) ? __ldg(a + static_cast<long long>(gm) * k + gk) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i / kBN, nn = i % kBN;
      const int gk = k0 + kk, gn = col0 + nn;
      bs[kk][nn] = (gk < k && gn < n) ? __ldg(b + static_cast<long long>(gk) * n + gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn < n) c[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n); f32, row-major, contiguous.
extern "C" int repro_matmul_f32(const void* a, const void* b, void* c, int m,
                                int n, int k, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const long long gx = (static_cast<long long>(m) + kBM - 1) / kBM;
  const long long gy = (static_cast<long long>(n) + kBN - 1) / kBN;
  if (gx > 2147483647LL || gy > 65535LL) return static_cast<int>(cudaErrorInvalidValue);
  matmul_f32_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                      dim3(kThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
