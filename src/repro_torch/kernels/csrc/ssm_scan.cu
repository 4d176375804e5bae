// Selective scan on Hopper: h_t = a_t * h_{t-1} + b_t along the time axis of
// (B, S, L) tensors (L = C*N lanes), h_{-1} = 0, the state kept in f32.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py::_scan_kernel,
// which carries a (bc, N) VMEM state across a sequential time grid of
// (bt, bc*N) tiles that must divide (S, C). Hopper's blocks run in no order, so
// nothing can carry across them: here each lane's whole recurrence lives in one
// thread, and no tile has to divide anything.
//
// What bounds it: bytes. Each element of a and b is read once and each h_t
// written once, 3*B*S*L*elem bytes, with one multiply and one add per element.
// At the falcon-mamba-7b prefill shape (B=2, S=1024, L=8192*16, f32) that is
// 3,221,225,472 B: 0.962 ms at 3.35 TB/s, and at least 61.5 ms for the 64
// launches of one prefill.
//
// Design: thread g owns lane (b, l) = (g / L, g % L) and walks t = 0..S-1 (or
// S-1..0 with reverse, the VJP's direction) with h in a register. Neighbouring
// threads take neighbouring lanes, which are contiguous in memory, so every
// load and store of a warp is one coalesced line. The loads of a_t and b_t do
// not depend on h: the loop loads kUnroll steps ahead into registers before
// the dependent chain uses them, so the chain does not wait on memory. The
// multiply and the add round separately (__fmul_rn, __fadd_rn, never a fused
// FMA), exactly as the plain PyTorch loop `a_t * h + b_t` does, so the kernel
// and its plain version agree bit for bit. Inputs and outputs are f32 or bf16;
// the state is f32 either way and h_t is rounded to the output type on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_record.h"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ h, long long lanes_total, long long seq,
                long long lanes, int reverse) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= lanes_total) return;
  const long long bi = g / lanes;
  const long long l = g - bi * lanes;
  // offset of step t of this lane: (bi*seq + t)*lanes + l
  const long long step = reverse ? -lanes : lanes;
  long long off = (bi * seq + (reverse ? seq - 1 : 0)) * lanes + l;
  float state = 0.f;
  long long t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = load(a + off + u * step);
      bv[u] = load(b + off + u * step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      store(h + off + u * step, state);
    }
    off += kUnroll * step;
  }
  for (; t < seq; ++t) {
    state = __fadd_rn(__fmul_rn(load(a + off), state), load(b + off));
    store(h + off, state);
    off += step;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, long long batch,
           long long seq, long long lanes, int reverse, cudaStream_t stream) {
  const long long total = batch * lanes;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  repro::record_launch(repro::kSsmScan, reverse, dim3(static_cast<unsigned>(blocks)), dim3(kThreads));
  ssm_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      total, seq, lanes, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h: (batch, seq, lanes), contiguous, all of one type: dtype 0 = f32,
// 1 = bf16. reverse != 0 walks t from seq-1 down to 0.
extern "C" int repro_ssm_scan(const void* a, const void* b, void* h,
                              long long batch, long long seq, long long lanes,
                              int dtype, int reverse, void* stream) {
  repro::record_begin();
  if (batch <= 0 || seq <= 0 || lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, batch, seq, lanes, reverse, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, batch, seq, lanes, reverse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
