// Segment sum on Hopper: out[s, :] = sum over edges e with seg[e] == s of
// msg[e, :], ids outside [0, S) -- the COO padding id -1 among them --
// dropped. msg and out are f32, bf16 or f16; the sum is taken in f32 and
// rounded once to the output type.
//
// Replaces the TPU kernel src/repro/kernels/segsum/segsum.py::_segsum_kernel,
// which rebuilds the scatter as one-hot(seg)^T @ msg on the MXU and sweeps
// the edge tiles in ascending order into an f32 accumulator.
//
// One summation order, whatever E, S or the launch: segment s's valid terms
// are taken in ascending edge index and cut into chunks of kChunk
// consecutive terms; each chunk is summed from 0 in f32, one add per term;
// the chunk sums are added in ascending order into a total that starts at
// 0. So a segment's bits depend on its own terms alone, two calls give the
// same bits, and no atomics are needed (kernels/segsum/ref.py::
// segment_sum_in_kernel_order writes the order out in PyTorch).
//
// What bounds it: bytes. Each message element is read once (E*D elements),
// each output element written once (S*D), plus the ids; one add per
// message element.
//
// Two paths; the wrapper (segsum/ops.py::plan) picks one by E:
//
//  - scan (few edges: the LM embedding's Σ by position). One launch, no
//    sort, no fill. A block owns kWarps output rows and a column slab; it
//    reads all E ids in ascending order, kThreads at a time, compacts the
//    edges that fall in its rows into shared memory, and each warp adds its
//    row's edges in order, kInFlight units of them loaded ahead.
//  - sorted (many edges: the GCN). The wrapper sorts the ids stably
//    (torch.sort: a permutation, none of the sum) and repro_segsum_starts
//    finds where each segment begins in that order. Then a warp per
//    (segment chunk, column slab) walks its chunk's rows through the
//    permutation -- each row a full coalesced read, kInFlight units ahead
//    of the adds -- and writes its output row once with a plain store. A
//    segment longer than kChunk writes its chunk sums to a workspace
//    instead, and a second grid adds them in order. Every output row is
//    written exactly once (empty segments as zeros), so the wrapper needs
//    no zero fill.
//
// Where the sorted path finds its chunks without a prefix sum: cut the
// sorted order into tiles of kChunk positions. A segment whose chunk c >= 1
// begins in tile t covers the tile's first position (it began before the
// tile), so each tile holds at most one such chunk head; and at most one
// segment longer than kChunk begins in a tile. So warps 0..S-1 take chunk 0
// of segment s, warp S+t takes the chunk c >= 1 that begins in tile t (if
// any), and a chunk's sum goes to workspace row 2*t + (c == 0): T*2 rows
// of D floats, T = ceil(E / kChunk).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_record.h"

namespace repro {
LaunchRecord g_launch_record{};
}  // namespace repro

namespace {

constexpr int kChunk = 256;   // L: terms per chunk of the summation order
constexpr int kWarps = 8;     // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kInFlight = 8;  // 16-byte units a lane loads ahead of its adds
constexpr unsigned kFull = 0xffffffffu;

// Element types by the wrapper's code: 0 f32, 1 bf16, 2 f16. Each maps
// between its bits and f32 (bf16 and f16 to f32 exactly; f32 to them
// rounding to nearest even).
template <int kType> struct Elem;
template <> struct Elem<0> {
  using Bits = unsigned int;
  __device__ static float get(Bits b) { return __uint_as_float(b); }
  __device__ static Bits put(float x) { return __float_as_uint(x); }
};
template <> struct Elem<1> {
  using Bits = unsigned short;
  __device__ static float get(Bits b) { return __uint_as_float(static_cast<unsigned>(b) << 16); }
  __device__ static Bits put(float x) {
    unsigned short r;
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
    return r;
  }
};
template <> struct Elem<2> {
  using Bits = unsigned short;
  __device__ static float get(Bits b) {
    float f;
    asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(b));
    return f;
  }
  __device__ static Bits put(float x) {
    unsigned short r;
    asm("cvt.rn.f16.f32 %0, %1;" : "=h"(r) : "f"(x));
    return r;
  }
};

// A lane's unit: N consecutive elements, moved as one access -- 16 bytes
// when N * sizeof(element) == 16, else one element.
template <int kType, int N>
struct Unit {
  using E = Elem<kType>;
  using Bits = typename E::Bits;
  using Raw = typename std::conditional<N == 1, Bits, uint4>::type;
  static_assert(N == 1 || N * sizeof(Bits) == 16, "a vector unit is 16 bytes");
  union View {
    Raw raw;
    Bits bits[N];
  };

  __device__ static Raw load(const Raw* p) { return __ldg(p); }
  __device__ static void add(Raw r, float (&acc)[N]) {
    View v;
    v.raw = r;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += E::get(v.bits[i]);
  }
  __device__ static Raw pack(const float (&x)[N]) {
    View v;
#pragma unroll
    for (int i = 0; i < N; ++i) v.bits[i] = E::put(x[i]);
    return v.raw;
  }
};

// Store a lane's N f32 values of one unit into a workspace row.
template <int N>
__device__ void store_f32(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
  }
}

// The rows at sorted positions [a, b) (b - a <= kChunk), summed in order
// into acc, which starts at 0: lane `lane` covers units c0 + 32*v of a row.
template <int kType, int N, int V>
__device__ void sum_run(const typename Unit<kType, N>::Raw* __restrict__ msg,
                        const long long* __restrict__ perm, long long a, long long b,
                        int width, int c0, float (&acc)[V][N]) {
  using U = Unit<kType, N>;
  constexpr int kAhead = kInFlight / V > 0 ? kInFlight / V : 1;
  const int lane = threadIdx.x & 31;
  for (long long base = a; base < b; base += 32) {
    // the permutation of 32 positions in one coalesced read, then shuffled
    const long long mine = base + lane < b ? __ldg(perm + base + lane) : 0;
    const int n = static_cast<int>(b - base < 32 ? b - base : 32);
    for (int j = 0; j < n; j += kAhead) {
      typename U::Raw buf[kAhead][V];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const long long e = __shfl_sync(kFull, mine, (j + u) & 31);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int c = c0 + 32 * v;
          if (j + u < n && c < width) buf[u][v] = U::load(msg + e * width + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (j + u < n && c0 + 32 * v < width) U::add(buf[u][v], acc[v]);
        }
      }
    }
  }
}

// Write a lane's units of an output row: the f32 total rounded once.
template <int kType, int N, int V>
__device__ void store_row(typename Unit<kType, N>::Raw* __restrict__ row, int width, int c0,
                          const float (&total)[V][N]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = c0 + 32 * v;
    if (c < width) row[c] = Unit<kType, N>::pack(total[v]);
  }
}

// ---------------------------------------------------------------------------
// The scan path
// ---------------------------------------------------------------------------

// A block owns kWarps consecutive output rows (a warp each) and a column
// slab. It reads the ids kThreads at a time, in ascending order; the edges
// whose id is one of its rows are compacted, still in ascending order, into
// a list in shared memory; each warp then takes its own row's entries from
// the list, loads up to kAhead of their rows ahead, and adds them in order.
template <int kType, int N, int V>
__global__ void __launch_bounds__(kThreads)
segsum_scan_kernel(const void* msg_, const int* __restrict__ seg, void* out_,
                   long long num_edges, int width, int num_segments) {
  using U = Unit<kType, N>;
  constexpr int kAhead = kInFlight / V > 0 ? kInFlight / V : 1;
  __shared__ int s_edge[kThreads];  // a window's matching edges, ascending
  __shared__ int s_row[kThreads];   // and the row (warp) each belongs to
  __shared__ int s_count[kWarps];
  const auto* msg = static_cast<const typename U::Raw*>(msg_);
  auto* out = static_cast<typename U::Raw*>(out_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long s = r0 + warp;
  const int c0 = blockIdx.y * 32 * V + lane;
  float acc[V][N] = {}, total[V][N] = {};
  int count = 0;  // terms in the open chunk
  int next = threadIdx.x < num_edges ? __ldg(seg + threadIdx.x) : -1;  // loaded a window ahead
  for (long long base = 0; base < num_edges; base += kThreads) {
    const long long row = static_cast<long long>(next) - r0;
    const long long ahead = base + kThreads + threadIdx.x;
    next = ahead < num_edges ? __ldg(seg + ahead) : -1;
    const bool match = row >= 0 && row < kWarps && r0 + row < num_segments;
    const unsigned m = __ballot_sync(kFull, match);
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int offset = 0, found = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      found += c;
    }
    if (match) {
      const int at = offset + __popc(m & ((1u << lane) - 1u));
      s_edge[at] = threadIdx.x;
      s_row[at] = static_cast<int>(row);
    }
    __syncthreads();
    for (int j0 = 0; j0 < found; j0 += 32) {
      unsigned mask = __ballot_sync(kFull, j0 + lane < found && s_row[j0 + lane] == warp);
      while (mask) {
        long long ed[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          ed[u] = mask ? base + s_edge[j0 + __ffs(mask) - 1] : -1;
          mask &= mask - 1;
        }
        typename U::Raw buf[kAhead][V];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int c = c0 + 32 * v;
            if (ed[u] >= 0 && c < width) buf[u][v] = U::load(msg + ed[u] * width + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (ed[u] < 0) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (c0 + 32 * v < width) U::add(buf[u][v], acc[v]);
          }
          if (++count == kChunk) {  // the chunk is full: add it to the total
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
              for (int i = 0; i < N; ++i) {
                total[v][i] += acc[v][i];
                acc[v][i] = 0.f;
              }
            count = 0;
          }
        }
      }
    }
    __syncthreads();  // the next window rewrites the list
  }
  if (s >= num_segments) return;
  if (count) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i) total[v][i] += acc[v][i];
  }
  store_row<kType, N, V>(out + s * width, width, c0, total);
}

// ---------------------------------------------------------------------------
// The sorted path
// ---------------------------------------------------------------------------

// starts[s] = the first sorted position whose id is >= s, for s in [0, S]:
// segment s occupies positions [starts[s], starts[s+1]); ids < 0 lie before
// starts[0], ids >= S from starts[S] on.
__global__ void __launch_bounds__(256)
segsum_starts_kernel(const int* __restrict__ sorted, long long num_edges, int num_segments,
                     int* __restrict__ starts) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s > num_segments) return;
  long long lo = 0, hi = num_edges;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(sorted + mid) < s) lo = mid + 1;
    else hi = mid;
  }
  starts[s] = static_cast<int>(lo);
}

// The chunk c >= 1 that begins in tile t, if any.
struct Head {
  int s, c;
  long long at, start, end;  // its first position; its segment's range
};

__device__ bool tile_head(long long t, const int* __restrict__ sorted,
                          const int* __restrict__ starts, long long num_edges,
                          int num_segments, Head& h) {
  const long long p = t * kChunk;
  if (p >= num_edges) return false;
  const int s = __ldg(sorted + p);
  if (s < 0 || s >= num_segments) return false;
  const long long st = __ldg(starts + s), en = __ldg(starts + s + 1);
  if (st == p) return false;  // chunk 0 of s: warp s takes it
  const int c = static_cast<int>((p - st + kChunk - 1) / kChunk);
  const long long at = st + static_cast<long long>(c) * kChunk;
  if (at >= en || at >= p + kChunk) return false;
  h = Head{s, c, at, st, en};
  return true;
}

// A warp per (segment, column slab) sums the segment's chunk 0, and a warp
// per (tile, column slab) the chunk c >= 1 that begins in the tile. Its
// warps each wait on three loads in a row (starts, the permutation, the
// rows): resident warps, not registers, keep the bytes in flight, so the
// kernel is held to the registers of 4 blocks an SM where a lane sums at
// most 8 floats of a row (f32 up to D = 256), and of 2 where it sums more
// (with 4 it spills).
template <int kType, int N, int V>
__global__ void __launch_bounds__(kThreads, (N * V <= 8 ? 4 : 2))
segsum_chunk_kernel(const void* msg_, const long long* __restrict__ perm,
                    const int* __restrict__ sorted, const int* __restrict__ starts,
                    float* __restrict__ ws, void* out_, long long num_edges, int width,
                    int num_segments, long long num_tiles) {
  using U = Unit<kType, N>;
  const auto* msg = static_cast<const typename U::Raw*>(msg_);
  auto* out = static_cast<typename U::Raw*>(out_);
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int c0 = blockIdx.y * 32 * V + lane;
  const long long row_floats = static_cast<long long>(width) * N;
  float acc[V][N] = {};
  long long ws_row;
  if (w < num_segments) {
    const long long st = __ldg(starts + w), en = __ldg(starts + w + 1);
    const long long stop = en - st > kChunk ? st + kChunk : en;
    sum_run<kType, N, V>(msg, perm, st, stop, width, c0, acc);
    if (en - st <= kChunk) {  // one chunk: the total is 0 + its sum
      float total[V][N];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int i = 0; i < N; ++i) total[v][i] = 0.f + acc[v][i];
      store_row<kType, N, V>(out + w * width, width, c0, total);
      return;
    }
    ws_row = 2 * (st / kChunk) + 1;
  } else if (w < num_segments + num_tiles) {
    Head h;
    if (!tile_head(w - num_segments, sorted, starts, num_edges, num_segments, h)) return;
    const long long stop = h.end - h.at > kChunk ? h.at + kChunk : h.end;
    sum_run<kType, N, V>(msg, perm, h.at, stop, width, c0, acc);
    ws_row = 2 * (w - num_segments);
  } else {
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = c0 + 32 * v;
    if (c < width) store_f32<N>(ws + ws_row * row_floats + static_cast<long long>(c) * N, acc[v]);
  }
}

// The chunk sums of each segment longer than kChunk, added in ascending
// order from 0: the warp of the tile where the segment's chunk 1 begins
// does it, a lane per f32 column.
template <int kType>
__global__ void __launch_bounds__(kThreads)
segsum_combine_kernel(const int* __restrict__ sorted, const int* __restrict__ starts,
                      const float* __restrict__ ws, void* out_, long long num_edges, int dim,
                      int num_segments, long long num_tiles) {
  using E = Elem<kType>;
  auto* out = static_cast<typename E::Bits*>(out_);
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= num_tiles) return;
  Head h;
  if (!tile_head(t, sorted, starts, num_edges, num_segments, h) || h.c != 1) return;
  const long long chunks = (h.end - h.start + kChunk - 1) / kChunk;
  for (int d = blockIdx.y * 32 + (threadIdx.x & 31); d < dim; d += 32 * gridDim.y) {
    float total = 0.f;
    for (long long c = 0; c < chunks; ++c) {
      const long long at = h.start + c * kChunk;
      const long long row = 2 * (at / kChunk) + (c == 0 ? 1 : 0);
      total += __ldg(ws + row * dim + d);
    }
    out[static_cast<long long>(h.s) * dim + d] = E::put(total);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

int units_per_lane(int width) { return width >= 128 ? 4 : width >= 64 ? 2 : 1; }

template <int kType, int N, int V>
int launch_v(const void* msg, const int* ids, const long long* perm, const int* starts,
             float* ws, void* out, long long num_edges, int width, int num_segments,
             cudaStream_t stream) {
  const int slabs_needed = (width + 32 * V - 1) / (32 * V);
  if (slabs_needed > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned slabs = static_cast<unsigned>(slabs_needed);
  constexpr int kUnitBytes = N * static_cast<int>(sizeof(typename Elem<kType>::Bits));
  if (!perm) {
    const long long blocks = (static_cast<long long>(num_segments) + kWarps - 1) / kWarps;
    repro::record_launch(repro::kSegsumScan, kUnitBytes, dim3(static_cast<unsigned>(blocks), slabs),
                         dim3(kThreads));
    segsum_scan_kernel<kType, N, V><<<dim3(static_cast<unsigned>(blocks), slabs), kThreads, 0,
                                      stream>>>(msg, ids, out, num_edges, width, num_segments);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (num_edges + kChunk - 1) / kChunk;
  const long long blocks = (num_segments + tiles + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  repro::record_launch(repro::kSegsumChunk, kUnitBytes, dim3(static_cast<unsigned>(blocks), slabs),
                       dim3(kThreads));
  segsum_chunk_kernel<kType, N, V><<<dim3(static_cast<unsigned>(blocks), slabs), kThreads, 0,
                                     stream>>>(msg, perm, ids, starts, ws, out, num_edges, width,
                                               num_segments, tiles);
  const int code = static_cast<int>(cudaGetLastError());
  if (code || tiles == 0) return code;
  const int dim = width * N;
  const unsigned dim_slabs = static_cast<unsigned>((dim + 31) / 32 < 65535 ? (dim + 31) / 32 : 65535);
  repro::record_launch(repro::kSegsumCombine, 0,
                       dim3(static_cast<unsigned>((tiles + kWarps - 1) / kWarps), dim_slabs),
                       dim3(kThreads));
  segsum_combine_kernel<kType><<<dim3(static_cast<unsigned>((tiles + kWarps - 1) / kWarps), dim_slabs),
                                 kThreads, 0, stream>>>(ids, starts, ws, out, num_edges, dim,
                                                        num_segments, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kType, int N>
int launch_n(const void* msg, const int* ids, const long long* perm, const int* starts,
             float* ws, void* out, long long num_edges, int width, int num_segments,
             cudaStream_t stream) {
  switch (units_per_lane(width)) {
    case 4: return launch_v<kType, N, 4>(msg, ids, perm, starts, ws, out, num_edges, width, num_segments, stream);
    case 2: return launch_v<kType, N, 2>(msg, ids, perm, starts, ws, out, num_edges, width, num_segments, stream);
    default: return launch_v<kType, N, 1>(msg, ids, perm, starts, ws, out, num_edges, width, num_segments, stream);
  }
}

template <int kType>
int launch_t(const void* msg, const int* ids, const long long* perm, const int* starts,
             float* ws, void* out, long long num_edges, int dim, int num_segments,
             cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(typename Elem<kType>::Bits));
  const bool vec = dim % kVec == 0 && reinterpret_cast<uintptr_t>(msg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return launch_n<kType, kVec>(msg, ids, perm, starts, ws, out, num_edges, dim / kVec,
                                 num_segments, stream);
  return launch_n<kType, 1>(msg, ids, perm, starts, ws, out, num_edges, dim, num_segments, stream);
}

}  // namespace

// The sorted path's segment starts: sorted (num_edges,) int32 ascending;
// starts (num_segments + 1,) int32.
extern "C" int repro_segsum_starts(const void* sorted, long long num_edges, int num_segments,
                                   void* starts, void* stream) {
  repro::record_begin();
  if (num_segments < 0 || num_edges < 0 || num_edges > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(num_segments) + 1 + 255) / 256;
  repro::record_launch(repro::kSegsumStarts, 0, dim3(static_cast<unsigned>(blocks)), dim3(256));
  segsum_starts_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted), num_edges, num_segments, static_cast<int*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// msg: (num_edges, dim) contiguous, of type `dtype` (0 f32, 1 bf16, 2 f16);
// out: (num_segments, dim) of the same type, every row written here.
// Scan path (perm == NULL): ids are the segment ids (num_edges,) int32.
// Sorted path: ids are those ids sorted stably, perm the positions they came
// from (int64), starts from repro_segsum_starts, ws 2*ceil(E/256)*dim f32.
extern "C" int repro_segsum(const void* msg, const void* ids, const void* perm,
                            const void* starts, void* ws, void* out, long long num_edges,
                            int dim, int num_segments, int dtype, void* stream) {
  if (!perm) repro::record_begin();  // the sorted path continues its starts call's record
  if (num_edges < 0 || dim < 0 || num_segments < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 0 || num_segments == 0) return 0;
  if (perm && (!starts || !ws)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i = static_cast<const int*>(ids);
  const auto* p = static_cast<const long long*>(perm);
  const auto* st = static_cast<const int*>(starts);
  auto* w = static_cast<float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<0>(msg, i, p, st, w, out, num_edges, dim, num_segments, s);
    case 1: return launch_t<1>(msg, i, p, st, w, out, num_edges, dim, num_segments, s);
    case 2: return launch_t<2>(msg, i, p, st, w, out, num_edges, dim, num_segments, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Copies the launch record of the last call (launch_record.h) into out, at
// most cap launches of repro::kLaunchInts ints each; returns how many
// launches the call made.
extern "C" int repro_last_launches(int* out, int cap) {
  const repro::LaunchRecord& r = repro::g_launch_record;
  const int n = r.count < repro::kMaxLaunches ? r.count : repro::kMaxLaunches;
  for (int i = 0; i < n && i < cap; ++i)
    for (int j = 0; j < repro::kLaunchInts; ++j) out[i * repro::kLaunchInts + j] = r.entries[i][j];
  return r.count;
}
