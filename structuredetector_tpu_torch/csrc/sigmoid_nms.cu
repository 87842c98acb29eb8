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
// far below the card's operations-per-byte balance for fp32. The earlier
// design (32 x 32 tiles, a 25-tap max from shared memory) spent more time
// on shared-memory loads (25 an output) and on sigmoids of a 27 % halo than
// the bytes need.
// What the design does about it: one 32-wide, 64-tall output tile a block
// of 32 x 4 threads, through the tiled front of sigmoid_nms_front.cuh: the
// block stages the sigmoid of 68 x 36 cells (20 % halo) with 16-byte loads,
// and takes the window max separably, 6.25 shared loads an output. A
// 128 x 128 plane is 8 blocks, so even the 32 part planes of a batch of 32
// launch 256 blocks on 132 SMs. A warp stores 32 consecutive floats of a
// row, one full 128-byte line, so wider stores would add a transpose and
// save no DRAM traffic. The wrapper hands the NCHW head slice in as it is,
// so no layout transpose surrounds the kernel (the Pallas version
// transposed NHWC to planes and back).
//
// The result is bit-identical to clamp(torch.sigmoid(x)) followed by
// max_pool2d on the same card.

#include <cuda_runtime.h>

#include "sigmoid_nms_front.cuh"

using namespace sdnet;

namespace {

__global__ void __launch_bounds__(kFrontThreads)
    sigmoid_nms_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int h, int w) {
  __shared__ __align__(16) float s[kStageFloats];
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int ox = blockIdx.x * kTileW;
  const int oy = blockIdx.y * kTileH;
  stage_tile(x + plane, s, oy, ox, h, w);
  __syncthreads();

  float* op = out + plane;
  const int gx = ox + threadIdx.x;
  const int gy0 = oy + threadIdx.y * kStripRows;
  suppress_tile(s, [&](int i, float v) {
    const int gy = gy0 + i;
    if (gy < h && gx < w) op[static_cast<size_t>(gy) * w + gx] = v;
  });
}

}  // namespace

// x, out: `planes` contiguous (h, w) float32 planes on the current device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sdnet_sigmoid_nms(const void* x, void* out, int planes, int h,
                                 int w, void* stream) {
  const dim3 block(kTileW, kStrips);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  planes);
  sigmoid_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
