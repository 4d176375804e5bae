// Segment sum on Hopper: out[s, :] = sum over edges e with seg[e] == s of msg[e, :].
//
// Replaces the TPU kernel src/repro/kernels/segsum/segsum.py::_segsum_kernel,
// which rebuilds the scatter as one-hot(seg)^T @ msg on the MXU because the TPU
// has no fast random-access scatter. The GPU has f32 atomics in L2, so this is
// the scatter itself: one f32 atomicAdd per (edge, feature) element.
//
// What bounds it: bytes. Each message element is read once (E*D*4 bytes) and
// added into the output; the atomics resolve in L2, so the output is touched
// in device memory about once (S*D*4 bytes) when it fits the 50 MB L2 and once
// per contribution when it does not. There is no arithmetic to speak of.
//
// Design: a block of 256 threads covers block_y = 256 / block_x edges; the
// block loads its segment ids into shared memory once, and within an edge
// neighbouring threads take neighbouring features, so the message reads are
// coalesced and the atomics of one warp land in one or two 128-byte lines.
// Ids outside [0, S) -- the COO padding id -1 among them -- are skipped. The
// caller zeroes the output. Edges whose destination is hot (the graphs'
// Pareto-skewed in-degree) serialise on their atomics: that costs speed, not
// correctness. The order of the additions changes from run to run, so results
// agree with any other summation order only to within f32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segsum_f32_kernel(const float* __restrict__ msg, const int* __restrict__ seg,
                  float* __restrict__ out, long long num_edges, int dim,
                  int num_segments) {
  __shared__ int s_seg[kThreads];
  const int rows = blockDim.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * rows;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < rows) {
    const long long e = e0 + t;
    s_seg[t] = e < num_edges ? seg[e] : -1;
  }
  __syncthreads();
  const long long e = e0 + threadIdx.y;
  const int s = s_seg[threadIdx.y];
  if (e >= num_edges || s < 0 || s >= num_segments) return;
  const float* src = msg + e * dim;
  float* dst = out + static_cast<long long>(s) * dim;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    atomicAdd(dst + d, __ldg(src + d));
  }
}

int block_width(int dim) {
  int w = 1;
  while (w < dim && w < 32) w <<= 1;
  return w;
}

}  // namespace

// msg: (num_edges, dim) f32, contiguous; seg: (num_edges,) int32;
// out: (num_segments, dim) f32, contiguous and zeroed by the caller.
extern "C" int repro_segsum_f32(const void* msg, const void* seg, void* out,
                                long long num_edges, int dim, int num_segments,
                                void* stream) {
  if (num_edges <= 0 || dim <= 0 || num_segments <= 0) return 0;
  const int bx = block_width(dim);
  const int by = kThreads / bx;
  const long long blocks = (num_edges + by - 1) / by;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  segsum_f32_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(bx, by), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msg), static_cast<const int*>(seg),
      static_cast<float*>(out), num_edges, dim, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
