// The launch record: what the last call of a C entry point launched. For
// each kernel: a code naming it, a variant (the bytes of a lane's unit,
// the tile's columns, the reduce's lanes per entry, the scan's direction),
// its gridDim and its blockDim. It lives on the host, so that a caller can
// hold the launches to its model of them (kernels/common.py::last_launches,
// the contracts of kernels/*/ops.py). Recording is a few host stores per
// launch: no synchronisation, and no result changes.
//
// Each entry point starts the record afresh, except repro_segsum's sorted
// path, which continues the record its repro_segsum_starts call began (the
// wrapper makes the two calls for one segment sum). The record is one per
// process, so it is read after a call on the thread that made it.

#pragma once

#include <cuda_runtime.h>

namespace repro {

enum KernelCode : int {
  kSegsumScan = 1,
  kSegsumStarts = 2,
  kSegsumChunk = 3,
  kSegsumCombine = 4,
  kGather = 5,
  kMatmulTiled = 6,
  kMatmulSkinny = 7,
  kMatmulReduce = 8,
  kSsmScan = 9,
};

constexpr int kMaxLaunches = 4;
constexpr int kLaunchInts = 8;  // code, variant, gridDim.xyz, blockDim.xyz

struct LaunchRecord {
  int count;
  int entries[kMaxLaunches][kLaunchInts];
};

extern LaunchRecord g_launch_record;  // defined in segsum.cu

inline void record_begin() { g_launch_record.count = 0; }

inline void record_launch(int code, int variant, dim3 grid, dim3 block) {
  LaunchRecord& r = g_launch_record;
  if (r.count < kMaxLaunches) {
    int* e = r.entries[r.count];
    e[0] = code;
    e[1] = variant;
    e[2] = static_cast<int>(grid.x);
    e[3] = static_cast<int>(grid.y);
    e[4] = static_cast<int>(grid.z);
    e[5] = static_cast<int>(block.x);
    e[6] = static_cast<int>(block.y);
    e[7] = static_cast<int>(block.z);
  }
  ++r.count;
}

}  // namespace repro
