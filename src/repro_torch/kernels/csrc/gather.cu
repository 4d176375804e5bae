// Row gather on Hopper: out[e, :] = table[rows[e], :], zero rows for ids
// outside [0, N).
//
// Replaces the TPU kernel src/repro/kernels/gather/gather.py::_gather_kernel,
// a scalar-prefetch DMA pipeline with one grid step per row, and the
// clamp-then-where masking of its wrapper (gather/ops.py). On the GPU a row
// gather is a plain random-access read, and the mask is one branch per row.
//
// What bounds it: bytes. E*D*4 bytes are written and as many read from the
// table (E*4 more for the ids); nothing is computed.
//
// Design: a block of 256 threads covers block_y = 256 / block_x output rows and
// loads their row ids into shared memory once. Within a row neighbouring
// threads copy neighbouring 16-byte words (float4) when D % 4 == 0 and both
// pointers are 16-byte aligned, else neighbouring floats, so every read and
// write is coalesced. Rows with an invalid id (the COO padding id -1 among
// them) are written as zeros inside the kernel. The copy moves bits: the
// result equals the plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ table, const int* __restrict__ rows,
              T* __restrict__ out, long long num_out, int num_rows, int width) {
  __shared__ int s_rows[kThreads];
  const int per_block = blockDim.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * per_block;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < per_block) {
    const long long e = e0 + t;
    s_rows[t] = e < num_out ? rows[e] : -1;
  }
  __syncthreads();
  const long long e = e0 + threadIdx.y;
  if (e >= num_out) return;
  const int r = s_rows[threadIdx.y];
  T* dst = out + e * width;
  if (r >= 0 && r < num_rows) {
    const T* src = table + static_cast<long long>(r) * width;
    for (int d = threadIdx.x; d < width; d += blockDim.x) dst[d] = __ldg(src + d);
  } else {
    const T zero{};
    for (int d = threadIdx.x; d < width; d += blockDim.x) dst[d] = zero;
  }
}

int block_width(int width) {
  int w = 1;
  while (w < width && w < 32) w <<= 1;
  return w;
}

template <typename T>
int launch(const void* table, const void* rows, void* out, long long num_out,
           int num_rows, int width, cudaStream_t stream) {
  const int bx = block_width(width);
  const int by = kThreads / bx;
  const long long blocks = (num_out + by - 1) / by;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<T><<<dim3(static_cast<unsigned>(blocks)), dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(rows),
      static_cast<T*>(out), num_out, num_rows, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (num_rows, dim) f32, contiguous; rows: (num_out,) int32;
// out: (num_out, dim) f32, contiguous.
extern "C" int repro_gather_f32(const void* table, const void* rows, void* out,
                                long long num_out, int num_rows, int dim,
                                void* stream) {
  if (num_out <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<float4>(table, rows, out, num_out, num_rows, dim / 4, s);
  return launch<float>(table, rows, out, num_out, num_rows, dim, s);
}
