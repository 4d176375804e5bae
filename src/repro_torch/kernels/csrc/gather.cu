// Row gather on Hopper: out[e, :] = table[rows[e], :], zero rows for ids
// outside [0, N). The copy moves bits, so one kernel serves every element
// size (4-byte f32, 2-byte bf16 and f16) and the result equals the plain
// version exactly.
//
// Replaces the TPU kernel src/repro/kernels/gather/gather.py::_gather_kernel,
// a scalar-prefetch DMA pipeline with one grid step per row, and the
// clamp-then-where masking of its wrapper (gather/ops.py). On the GPU a row
// gather is a plain random-access read, and the mask is one branch per row.
//
// What bounds it: bytes. E*D elements are written and as many read from
// the table (fewer where rows repeat and L2 holds them), E*4 bytes of ids;
// nothing is computed.
//
// Design. Moving the bytes at the card's rate needs many loads in flight:
// each thread copies R rows x V units (a unit is 16 bytes when a row's
// bytes are a multiple of 16 and both pointers are 16-byte aligned, else
// one element), and issues all R*V loads before its first store, so a lane
// has kRV = R*V units in flight. A block is G lanes per row x 256/G rows;
// the grid is (row groups, column slabs), so wide rows (D = 4,096, E =
// 2,048: 1,024 blocks) are split across blocks and fill the 132 SMs. The
// output is written with streaming stores (st.global.cs), so that it does
// not evict from L2 the table rows that later edges read again. Rows with
// an invalid id (the COO padding id -1 among them) are written as zeros
// inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_record.h"

namespace {

constexpr int kThreads = 256;

template <typename U, int V, int R>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const U* __restrict__ table, const int* __restrict__ rows, U* __restrict__ out,
              long long num_out, int num_rows, int width) {
  const int lanes = blockDim.x, slots = blockDim.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * slots * R + threadIdx.y;
  const int c0 = blockIdx.y * lanes * V + threadIdx.x;
  int r[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long e = e0 + static_cast<long long>(k) * slots;
    r[k] = e < num_out ? __ldg(rows + e) : -1;
  }
  U buf[R][V];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const bool valid = r[k] >= 0 && r[k] < num_rows;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + v * lanes;
      buf[k][v] = U{};
      if (valid && c < width) buf[k][v] = __ldg(table + static_cast<long long>(r[k]) * width + c);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long e = e0 + static_cast<long long>(k) * slots;
    if (e >= num_out) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + v * lanes;
      if (c < width) __stcs(out + e * width + c, buf[k][v]);
    }
  }
}

template <typename U, int V, int R>
int launch_shape(const void* table, const void* rows, void* out, long long num_out,
                 int num_rows, int width, int lanes, cudaStream_t stream) {
  const int slots = kThreads / lanes;
  const long long groups = (num_out + static_cast<long long>(slots) * R - 1) / (slots * R);
  const long long slabs = (width + static_cast<long long>(lanes) * V - 1) / (lanes * V);
  if (groups > 2147483647LL || slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(slabs)), block(lanes, slots);
  repro::record_launch(repro::kGather, static_cast<int>(sizeof(U)), grid, block);
  gather_kernel<U, V, R><<<grid, block, 0, stream>>>(
      static_cast<const U*>(table), static_cast<const int*>(rows), static_cast<U*>(out),
      num_out, num_rows, width);
  return static_cast<int>(cudaGetLastError());
}

// (lanes per row, units per lane, rows per thread) by a row's width in
// units: 8 units in flight per lane; narrow rows share a warp.
template <typename U>
int launch(const void* table, const void* rows, void* out, long long num_out, int num_rows,
           int width, cudaStream_t stream) {
  if (width >= 128) return launch_shape<U, 4, 2>(table, rows, out, num_out, num_rows, width, 32, stream);
  if (width >= 64) return launch_shape<U, 2, 4>(table, rows, out, num_out, num_rows, width, 32, stream);
  int lanes = 1;
  while (lanes < width && lanes < 32) lanes <<= 1;
  return launch_shape<U, 1, 8>(table, rows, out, num_out, num_rows, width, lanes, stream);
}

}  // namespace

// table: (num_rows, dim) contiguous; rows: (num_out,) int32; out:
// (num_out, dim) contiguous; elements of elem_size bytes (4 or 2).
extern "C" int repro_gather(const void* table, const void* rows, void* out, long long num_out,
                            int num_rows, int dim, int elem_size, void* stream) {
  repro::record_begin();
  if (num_out < 0 || num_rows < 0 || dim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_out == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (static_cast<long long>(dim) * elem_size) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<uint4>(table, rows, out, num_out, num_rows, dim * elem_size / 16, s);
  if (elem_size == 4) return launch<unsigned int>(table, rows, out, num_out, num_rows, dim, s);
  if (elem_size == 2) return launch<unsigned short>(table, rows, out, num_out, num_rows, dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
