// Kernel B: clamped sigmoid + 5x5 plateau NMS + top-k, one block per plane.
//
// Replaces structuredetector_tpu/ops/pallas/topk.py::_sigmoid_nms_topk_kernel
// (fused_sigmoid_nms_topk, variant="rounds"). Same function: suppress the
// plane as kernel A does, then k rounds of (largest value, smallest flat
// index y * W + x holding it, mask it to -1). With fewer than k peaks the
// zeros of the suppressed plane are taken in ascending index order.
//
// What bounds it on an H100: bytes, on the roofline. The work needs one
// read of the logits (4.2 MB for the anchor planes of a batch of 32, about
// 1.25 us at 3.35 TB/s) and a few hundred operations a pixel at most. In
// practice the k selection rounds, a chain of dependent block-wide
// reductions, take far longer than either: latency, not a rate, is the
// limit this first version lives with.
// What the design does about it: the plane stays on chip from the load to
// the last round, so DRAM sees each logit once. The block stages the
// sigmoid plane and then the suppressed plane in shared memory (two 64 KiB
// buffers for a 128x128 plane); a plane too large for shared memory (up to
// 256x256) uses a scratch buffer from the wrapper instead, which stays in
// L2. Each thread owns the pixels p = tid + j * 512 and keeps the best
// (value, index) among them in registers, so a round is one reduction of
// 512 candidates (warp shuffles, then one warp over the 16 warp winners);
// only the thread that owned the winner rescans its own pixels. Plane-level
// parallelism comes from the grid: one block for each of the B * C planes.
//
// The sigmoid + NMS front is sigmoid_nms_front.cuh, shared with kernels A
// and C, so values and indices are bit-identical to the plain PyTorch
// version on the same card.

#include <climits>
#include <cuda_runtime.h>

#include "sigmoid_nms_front.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Selection order: larger value first, then smaller flat index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sigmoid_nms_topk_kernel(const float* __restrict__ x,
                            float* __restrict__ vals, int* __restrict__ inds,
                            float* scratch, int h, int w, int k) {
  extern __shared__ float smem[];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int win_i;

  const int n = h * w;
  const int plane = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sig = scratch ? scratch + static_cast<size_t>(plane) * 2 * n : smem;
  float* sup = sig + n;
  const float* xp = x + static_cast<size_t>(plane) * n;

  sdnet::sigmoid_plane(xp, sig, n);
  __syncthreads();

  float best_v = -2.0f;  // below the -1 mask: a thread with no pixels never wins
  int best_i = INT_MAX;
  for (int p = tid; p < n; p += kThreads) {
    const int y = p / w;
    const float s = sdnet::plateau_nms_at(sig, y, p - y * w, h, w);
    sup[p] = s;
    if (s > best_v) {  // ascending p: strict > keeps the smallest index
      best_v = s;
      best_i = p;
    }
  }

  float* out_v = vals + static_cast<size_t>(plane) * k;
  int* out_i = inds + static_cast<size_t>(plane) * k;
  for (int r = 0; r < k; ++r) {
    float v = best_v;
    int i = best_i;
    warp_best(v, i);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : -2.0f;
      i = lane < kWarps ? warp_i[lane] : INT_MAX;
      warp_best(v, i);
      if (lane == 0) {
        win_i = i;
        out_v[r] = v;
        out_i[r] = i;
      }
    }
    __syncthreads();
    const int wi = win_i;
    if (tid == wi % kThreads) {  // the owner masks the winner and rescans
      sup[wi] = -1.0f;
      best_v = -2.0f;
      best_i = INT_MAX;
      for (int p = tid; p < n; p += kThreads) {
        const float s = sup[p];
        if (s > best_v) {
          best_v = s;
          best_i = p;
        }
      }
    }
  }
}

}  // namespace

// x: `planes` contiguous (h, w) float32 planes; vals (planes, k) float32 and
// inds (planes, k) int32 outputs. `scratch` is null to keep each plane in
// shared memory (8 * h * w bytes of it), else a (planes, 2, h * w) float32
// buffer. Launches on `stream` and returns cudaGetLastError() (or the error
// of raising the block's shared-memory limit).
extern "C" int sdnet_sigmoid_nms_topk(const void* x, void* vals, void* inds,
                                      void* scratch, int planes, int h, int w,
                                      int k, void* stream) {
  const size_t smem_bytes =
      scratch ? 0 : 2 * static_cast<size_t>(h) * w * sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      sigmoid_nms_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  sigmoid_nms_topk_kernel<<<planes, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(inds), static_cast<float*>(scratch), h, w, k);
  return static_cast<int>(cudaGetLastError());
}
