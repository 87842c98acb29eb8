// The decode front that kernels A, B and C share: the clamped sigmoid and
// the 5x5 plateau NMS of one pixel.
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
// clamp(torch.sigmoid(x)) followed by max_pool2d on the same card. Kept in
// one place so the kernels cannot drift apart.

#pragma once

#include <cuda_runtime.h>

namespace sdnet {

constexpr int kNmsPad = 2;  // 5x5 window

__device__ __forceinline__ float clamped_sigmoid(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return fminf(fmaxf(s, 1e-6f), 0.999999f);
}

// sig[p] = clamped_sigmoid(x[p]) for the n pixels of a plane, strided over
// the block's threads.
__device__ __forceinline__ void sigmoid_plane(const float* __restrict__ x,
                                              float* sig, int n) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    sig[p] = clamped_sigmoid(x[p]);
  }
}

// The suppressed value of pixel (y, xx) of an (h, w) sigmoid plane: its
// value where it is the max of its 5x5 window, else 0.
__device__ __forceinline__ float plateau_nms_at(const float* sig, int y,
                                                int xx, int h, int w) {
  const int y0 = max(y - kNmsPad, 0), y1 = min(y + kNmsPad, h - 1);
  const int x0 = max(xx - kNmsPad, 0), x1 = min(xx + kNmsPad, w - 1);
  float m = -1.0f;
  for (int yy = y0; yy <= y1; ++yy) {
    for (int xq = x0; xq <= x1; ++xq) m = fmaxf(m, sig[yy * w + xq]);
  }
  const float c = sig[y * w + xx];
  return (c == m) ? c : 0.0f;
}

}  // namespace sdnet
