// Kernel C: clamped sigmoid + 5x5 plateau NMS + top-k through a per-row-max
// table, one block per plane.
//
// Replaces structuredetector_tpu/ops/pallas/topk.py::
// _sigmoid_nms_topk_onehot_kernel (fused_sigmoid_nms_topk,
// variant="onehot"). Same function as kernel B (sigmoid_nms_topk.cu): values
// and flat indices y * W + x of the k largest suppressed values, ties to the
// smallest flat index, the zeros of the plane in ascending index order when
// it has fewer than k peaks.
//
// What bounds it on an H100: bytes, on the roofline, as kernel B: one read
// of the logits (4.2 MB for the anchor planes of a batch of 32, 1.25 us at
// 3.35 TB/s) and k values and indices out. In practice the front (sigmoid +
// 25-tap window a pixel, by one block a plane) and then the chain of k
// dependent selection rounds set the time: latency, not a rate.
// What the design does about it: the front is the clamped sigmoid of
// sigmoid_nms_front.cuh, shared with kernels A and B so the three cannot
// drift apart, over the whole plane, and a 25-tap window max a pixel (the
// tiled front of kernels A and B is not used here yet). The plane stays on
// chip (sigmoid and suppressed planes in shared memory; a plane too large
// for it, up to 256x256, in a scratch buffer from the wrapper that stays in
// L2). The suppressed plane is computed row by row, one warp a row, so each
// row's max falls out of the same pass into a rowmax[H] table. Then one warp
// runs the k rounds alone, with no block barrier:
//   1. reduce rowmax to (max, smallest row holding it): H/32 loads a lane
//      and one warp reduction;
//   2. scan that row for (max, smallest column): W/32 loads a lane and one
//      warp reduction; each lane also keeps its runner-up;
//   3. mask the pick to -1 in place (the Pallas kernel kept the suppressed
//      block read-only and re-masked earlier picks of the row every round;
//      here the plane is writable, so that is one store) and rewrite
//      rowmax[row] from the lanes' runners-up: one more warp reduction.
// The smallest row holding the max, then its smallest column holding it, is
// the smallest flat index holding the max, so the order is kernel B's.
// A round costs O(H/32 + W/32) loads a lane and three warp reductions.

#include <climits>
#include <cuda_runtime.h>

#include "sigmoid_nms_front.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMasked = -1.0f;  // a taken pixel; below every suppressed value
constexpr float kNone = -2.0f;    // a lane with no pixel; below the mask

// sig[p] = clamped_sigmoid(x[p]) for the n pixels of a plane, strided over
// the block's threads.
__device__ __forceinline__ void sigmoid_plane(const float* __restrict__ x,
                                              float* sig, int n) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    sig[p] = sdnet::clamped_sigmoid(x[p]);
  }
}

// The suppressed value of pixel (y, xx) of an (h, w) sigmoid plane: its
// value where it is the max of its 5x5 window, else 0.
__device__ __forceinline__ float plateau_nms_at(const float* sig, int y,
                                                int xx, int h, int w) {
  constexpr int kPad = sdnet::kNmsPad;
  const int y0 = max(y - kPad, 0), y1 = min(y + kPad, h - 1);
  const int x0 = max(xx - kPad, 0), x1 = min(xx + kPad, w - 1);
  float m = -1.0f;
  for (int yy = y0; yy <= y1; ++yy) {
    for (int xq = x0; xq <= x1; ++xq) m = fmaxf(m, sig[yy * w + xq]);
  }
  const float c = sig[y * w + xx];
  return (c == m) ? c : 0.0f;
}

// Selection order: larger value first, then smaller index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Butterfly reduction: every lane ends with the warp's best (value, index).
__device__ __forceinline__ void warp_best_all(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    sigmoid_nms_topk_rowmax_kernel(const float* __restrict__ x,
                                   float* __restrict__ vals,
                                   int* __restrict__ inds, float* scratch,
                                   int h, int w, int k) {
  extern __shared__ float smem[];
  const int n = h * w;
  const int plane = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sig = scratch ? scratch + static_cast<size_t>(plane) * (2 * n + h)
                       : smem;
  float* sup = sig + n;
  float* rowmax = sup + n;
  const float* xp = x + static_cast<size_t>(plane) * n;

  sigmoid_plane(xp, sig, n);
  __syncthreads();

  // The suppressed plane, one warp a row, and each row's max.
  for (int y = warp; y < h; y += kWarps) {
    float m = kNone;
    for (int c = lane; c < w; c += 32) {
      const float s = plateau_nms_at(sig, y, c, h, w);
      sup[y * w + c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max_all(m);
    if (lane == 0) rowmax[y] = m;
  }
  __syncthreads();
  if (warp != 0) return;

  float* out_v = vals + static_cast<size_t>(plane) * k;
  int* out_i = inds + static_cast<size_t>(plane) * k;
  for (int r = 0; r < k; ++r) {
    // 1. the winning row: ascending rows, strict > keeps the smallest
    float row_v = kNone;
    int row = INT_MAX;
    for (int y = lane; y < h; y += 32) {
      const float v = rowmax[y];
      if (v > row_v) {
        row_v = v;
        row = y;
      }
    }
    warp_best_all(row_v, row);

    // 2. the winning column of that row, and each lane's runner-up
    float* line = sup + static_cast<size_t>(row) * w;
    float v1 = kNone, v2 = kNone;
    int c1 = INT_MAX;
    for (int c = lane; c < w; c += 32) {
      const float s = line[c];
      if (s > v1) {
        v2 = v1;
        v1 = s;
        c1 = c;
      } else if (s > v2) {
        v2 = s;
      }
    }
    float col_v = v1;
    int col = c1;
    warp_best_all(col_v, col);

    // 3. mask the pick and rewrite the row's max: the owner of the pick
    // offers its runner-up (or the mask it just stored), the others their
    // best
    const bool owner = (c1 == col);
    if (owner) line[col] = kMasked;
    const float new_max = warp_max_all(owner ? fmaxf(v2, kMasked) : v1);
    if (lane == 0) {
      rowmax[row] = new_max;
      out_v[r] = col_v;
      out_i[r] = row * w + col;
    }
    __syncwarp();  // the mask and the table are read by the next round
  }
}

}  // namespace

// x: `planes` contiguous (h, w) float32 planes; vals (planes, k) float32 and
// inds (planes, k) int32 outputs. `scratch` is null to keep each plane in
// shared memory ((2 * h * w + h) floats of it), else a (planes, 2 * h * w + h)
// float32 buffer. Launches on `stream` and returns cudaGetLastError() (or
// the error of raising the block's shared-memory limit).
extern "C" int sdnet_sigmoid_nms_topk_rowmax(const void* x, void* vals,
                                             void* inds, void* scratch,
                                             int planes, int h, int w, int k,
                                             void* stream) {
  const size_t smem_bytes =
      scratch ? 0
              : (2 * static_cast<size_t>(h) * w + h) * sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      sigmoid_nms_topk_rowmax_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  sigmoid_nms_topk_rowmax_kernel<<<planes, kThreads, smem_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(inds), static_cast<float*>(scratch), h, w, k);
  return static_cast<int>(cudaGetLastError());
}
