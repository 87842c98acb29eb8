// The tiled decode front that kernel A and kernel B's first phase share:
// the clamped sigmoid and the 5x5 plateau NMS of one 32-wide, 64-tall
// output tile, computed by a block of 32 x 4 threads.
//
// Replaces the front of structuredetector_tpu/ops/pallas/nms.py and
// ops/pallas/topk.py: s = clamp(sigmoid(x), 1e-6, 1 - 1e-6), and a pixel
// keeps s iff s equals the max of its 5x5 window, else 0. Cells outside the
// plane never win (the Pallas kernels' -1 halo, the -inf padding of
// max_pool2d).
//
// The sigmoid is 1 / (1 + expf(-x)), the formula of ATen's CUDA sigmoid.
// Every file that includes this header is compiled without
// --use_fast_math, so the result is bit-identical to
// clamp(torch.sigmoid(x)) followed by max_pool2d on the same card.
//
// What bounds the front on an H100: DRAM bytes (one read of each logit),
// as long as the window max stays off the shared-memory pipe. A 25-tap max
// read from shared memory costs 25 loads an output, which at one warp-wide
// load an SM a clock is above the byte bound. The design:
// - stage_tile writes the clamped sigmoid of the tile plus a 2-cell halo
//   (68 x 36 cells, 20 % more than the outputs) into shared memory, with
//   16-byte loads and stores for the 32 interior columns when the row
//   allows them (w % 4 == 0, the tile inside the plane, an aligned plane);
// - suppress_tile takes the window max separably, which is exact because
//   fmaxf is associative and commutative: each thread owns one column and
//   a strip of 16 rows, takes the 5-wide max of each of the 20 staged rows
//   it needs (5 loads a row; the middle one is the centre value) and then
//   the 5-tall max over those row maxima in registers. That is
//   5 * 20 / 16 = 6.25 shared loads an output instead of 25. The equality
//   test c == m is the plain version's.
// A 32 x 64 tile has a smaller halo share than 32 x 32 and still gives
// 8 blocks a 128 x 128 plane, so a batch of 32 fills the card's 132 SMs.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sdnet {

constexpr int kNmsPad = 2;                         // 5x5 window
constexpr int kTileW = 32;                         // output columns a tile
constexpr int kTileH = 64;                         // output rows a tile
constexpr int kStrips = 4;                         // thread rows: blockDim (32, 4)
constexpr int kStripRows = kTileH / kStrips;       // output rows a thread
constexpr int kFrontThreads = kTileW * kStrips;    // 128
constexpr int kStageRows = kTileH + 2 * kNmsPad;   // 68
constexpr int kStageCols = kTileW + 2 * kNmsPad;   // 36
// Shared row pitch. Staged column c (plane column ox - 2 + c) sits at
// index c + 2, so the 32 interior columns start at index 4 and every row
// starts on a 16-byte boundary (40 floats = 160 bytes).
constexpr int kPitch = kTileW + 8;
constexpr int kStageFloats = kStageRows * kPitch;

__device__ __forceinline__ float clamped_sigmoid(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return fminf(fmaxf(s, 1e-6f), 0.999999f);
}

// Stage the clamped sigmoid of the tile whose first output is (oy, ox),
// with its halo, into s (kStageRows rows of kPitch floats, 16-byte
// aligned). xp is the plane's first logit; cells outside the (h, w) plane
// get -1, below the clamped sigmoid's range, so the halo never wins a max.
// Each thread issues all of its loads before its first sigmoid, so their
// DRAM latencies overlap instead of adding up loop trip by loop trip.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xp,
                                           float* s, int oy, int ox, int h,
                                           int w) {
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  // staged cell (r, c) is plane cell (oy - 2 + r, ox - 2 + c)
  auto inside = [&](int r, int c) {
    const int gy = oy - kNmsPad + r, gx = ox - kNmsPad + c;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  };
  auto at = [&](int r, int c) {
    return xp + static_cast<size_t>(oy - kNmsPad + r) * w + ox - kNmsPad + c;
  };
  const bool vec = (w & 3) == 0 && ox + kTileW <= w &&
                   (reinterpret_cast<uintptr_t>(xp) & 15) == 0;
  if (vec) {
    // the 32 interior columns as float4s, then the halo columns: staged 0,
    // 1 (left) and 34, 35 (right)
    constexpr int kQuads = kTileW / 4;
    constexpr int kQuadCells = kStageRows * kQuads;
    constexpr int kQuadIters = (kQuadCells + kFrontThreads - 1) / kFrontThreads;
    constexpr int kHaloCells = kStageRows * 4;
    constexpr int kHaloIters = (kHaloCells + kFrontThreads - 1) / kFrontThreads;
    auto halo_col = [](int i) { return (i & 3) < 2 ? (i & 3) : kTileW + (i & 3); };
    float4 quad[kQuadIters];
    float halo[kHaloIters];
#pragma unroll
    for (int u = 0; u < kQuadIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i / kQuads, c = kNmsPad + 4 * (i % kQuads);
      if (i < kQuadCells && inside(r, c)) {
        quad[u] = __ldg(reinterpret_cast<const float4*>(at(r, c)));
      }
    }
#pragma unroll
    for (int u = 0; u < kHaloIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i >> 2, c = halo_col(i);
      if (i < kHaloCells && inside(r, c)) halo[u] = __ldg(at(r, c));
    }
#pragma unroll
    for (int u = 0; u < kQuadIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i / kQuads, c = kNmsPad + 4 * (i % kQuads);
      if (i >= kQuadCells) break;
      float4 v = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
      if (inside(r, c)) {
        v = make_float4(clamped_sigmoid(quad[u].x), clamped_sigmoid(quad[u].y),
                        clamped_sigmoid(quad[u].z), clamped_sigmoid(quad[u].w));
      }
      *reinterpret_cast<float4*>(s + r * kPitch + c + 2) = v;
    }
#pragma unroll
    for (int u = 0; u < kHaloIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i >> 2, c = halo_col(i);
      if (i >= kHaloCells) break;
      s[r * kPitch + c + 2] = inside(r, c) ? clamped_sigmoid(halo[u]) : -1.0f;
    }
  } else {
    constexpr int kCells = kStageRows * kStageCols;
    constexpr int kIters = (kCells + kFrontThreads - 1) / kFrontThreads;
    float cell[kIters];
#pragma unroll
    for (int u = 0; u < kIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i / kStageCols, c = i % kStageCols;
      if (i < kCells && inside(r, c)) cell[u] = __ldg(at(r, c));
    }
#pragma unroll
    for (int u = 0; u < kIters; ++u) {
      const int i = tid + u * kFrontThreads;
      const int r = i / kStageCols, c = i % kStageCols;
      if (i >= kCells) break;
      s[r * kPitch + c + 2] = inside(r, c) ? clamped_sigmoid(cell[u]) : -1.0f;
    }
  }
}

// The suppressed values of the thread's column (threadIdx.x) over its
// strip of kStripRows output rows, from a staged tile: calls
// emit(i, value) for i = 0 .. kStripRows - 1, the tile row
// threadIdx.y * kStripRows + i. i is a constant after unrolling, so emit
// may index a register array with it.
template <class Emit>
__device__ __forceinline__ void suppress_tile(const float* s, Emit emit) {
  constexpr int kRows = kStripRows + 2 * kNmsPad;
  const float* col = s + threadIdx.y * kStripRows * kPitch + threadIdx.x + 2;
  float hmax[kRows];
  float centre[kStripRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float* row = col + q * kPitch;  // staged columns tx .. tx + 4
    const float a = row[0], b = row[1], c = row[2], d = row[3], e = row[4];
    hmax[q] = fmaxf(fmaxf(fmaxf(a, b), fmaxf(c, d)), e);
    if (q >= kNmsPad && q < kStripRows + kNmsPad) centre[q - kNmsPad] = c;
  }
#pragma unroll
  for (int i = 0; i < kStripRows; ++i) {
    const float m = fmaxf(fmaxf(fmaxf(hmax[i], hmax[i + 1]),
                                fmaxf(hmax[i + 2], hmax[i + 3])),
                          hmax[i + 4]);
    emit(i, centre[i] == m ? centre[i] : 0.0f);
  }
}

}  // namespace sdnet
