// Kernel A: clamped sigmoid + 5x5 plateau NMS over NCHW heatmap planes.
//
// Replaces structuredetector_tpu/ops/pallas/nms.py::_sigmoid_nms_kernel,
// reached through fused_sigmoid_nms. Same function: for s = clamp(sigmoid(x),
// 1e-6, 1 - 1e-6), out = s where s equals the max of its 5x5 window, else 0.
// Cells outside the plane never win (the Pallas kernel's -1 halo, the
// -inf padding of max_pool2d).
//
// What bounds it on an H100: bytes. Each logit is read once and each output
// written once (8 bytes a pixel); the window max is ~30 operations a pixel,
// far below the card's operations-per-byte balance for fp32.
// What the design does about it: one 32x32 output tile per block. The block
// stages the 36x36 logits it needs in shared memory, applies the sigmoid
// once per staged cell, and takes the 25-tap max from shared memory, so the
// halo costs L2 reads and no extra DRAM traffic. A warp reads and writes 32
// contiguous floats of a row. The wrapper hands the NCHW head slice in as it
// is, so no layout transpose surrounds the kernel (the Pallas version
// transposed NHWC to planes and back).
//
// The sigmoid is 1 / (1 + expf(-x)), the formula of ATen's CUDA sigmoid. The
// file is compiled without --use_fast_math, so the result is bit-identical to
// clamp(torch.sigmoid(x)) followed by max_pool2d on the same card.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPad = 2;
constexpr int kHalo = kTile + 2 * kPad;
constexpr int kRows = 8;  // thread rows; each thread covers kTile / kRows rows

__device__ __forceinline__ float clamped_sigmoid(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return fminf(fmaxf(s, 1e-6f), 0.999999f);
}

__global__ void __launch_bounds__(kTile * kRows)
    sigmoid_nms_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int h, int w) {
  __shared__ float tile[kHalo][kHalo + 1];
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const float* xp = x + plane;
  float* op = out + plane;
  const int ox = blockIdx.x * kTile;
  const int oy = blockIdx.y * kTile;

  // -1 is below the clamped sigmoid's range, so the halo never wins a max.
  for (int i = threadIdx.y * kTile + threadIdx.x; i < kHalo * kHalo;
       i += kTile * kRows) {
    const int ly = i / kHalo;
    const int lx = i - ly * kHalo;
    const int gy = oy + ly - kPad;
    const int gx = ox + lx - kPad;
    tile[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? clamped_sigmoid(xp[static_cast<size_t>(gy) * w + gx])
                       : -1.0f;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int gx = ox + tx;
  for (int ty = threadIdx.y; ty < kTile; ty += kRows) {
    const int gy = oy + ty;
    if (gy >= h || gx >= w) continue;
    float m = -1.0f;
#pragma unroll
    for (int dy = 0; dy < 2 * kPad + 1; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2 * kPad + 1; ++dx) {
        m = fmaxf(m, tile[ty + dy][tx + dx]);
      }
    }
    const float c = tile[ty + kPad][tx + kPad];
    op[static_cast<size_t>(gy) * w + gx] = (c == m) ? c : 0.0f;
  }
}

}  // namespace

// x, out: `planes` contiguous (h, w) float32 planes on the current device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sdnet_sigmoid_nms(const void* x, void* out, int planes, int h,
                                 int w, void* stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, planes);
  sigmoid_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
