// Kernel B: clamped sigmoid + 5x5 plateau NMS + top-k of each plane, as an
// exact two-phase selection over tiles.
//
// Replaces structuredetector_tpu/ops/pallas/topk.py::_sigmoid_nms_topk_kernel
// (fused_sigmoid_nms_topk, variant="rounds"). Same function: suppress the
// plane as kernel A does, then the k largest suppressed values, each with
// the smallest flat index y * W + x holding it, in descending order. With
// fewer than k peaks the zeros of the suppressed plane follow in ascending
// index order.
//
// What bounds it on an H100: bytes, on the roofline. The work needs one
// read of the logits (4.2 MB for the anchor planes of a batch of 32, about
// 1.25 us at 3.35 TB/s) and a few hundred operations a pixel at most. The
// earlier design ran one 512-thread block a plane (64 blocks for the anchor
// planes of a batch of 32, on 132 SMs), each doing the whole front of its
// plane alone and then k dependent block-wide reduction rounds: latency,
// not a rate, set its time.
// What the design does about it: no block a plane and no serial rounds.
//
// Keys. A suppressed value s is 0 or lies in [1e-6, 1 - 1e-6], so its bit
// pattern orders as an unsigned integer. The 64-bit key
// (float_as_uint(s) << 32) | (0xFFFFFFFF - flat) orders as the selection
// does: larger value first, then smaller flat index. Keys are unique within
// a plane, every key of a pixel is above 0, and 0 is the sentinel for cells
// past a ragged edge and for unused slots.
//
// Phase 1, topk_tiles_kernel, a block a (plane, tile): 8 blocks of
// 32 x 4 threads for a 128 x 128 plane, so the 96 planes of a batch of 32
// launch 768 blocks. Each block runs the tiled front of
// sigmoid_nms_front.cuh on its 32 x 64 tile, keeps its 2048 keys in
// registers (16 a thread), and finds the tile's kk = min(k, valid pixels)
// largest by a radix select on the value half of the keys, one byte a pass
// from the top, stopping as soon as the bin that holds the kk-th value is
// taken whole. The first byte has only 12 possible values and is counted
// in registers and by warp shuffles, with no atomics. The value's other
// bytes go on a 256-bin histogram over all keys, with warp-aggregated
// atomics (on a plateau, as a trained head's saturated background gives,
// nearly every key is in play). If four passes end on a tie at the kk-th
// value, the tied keys are ranked in row-major order, which is flat-index
// order within a tile, by warp ballots: no pass over the index bits. One
// path serves random planes and plateaus alike: a second path for tiles
// with few keys in play paid off on random planes only, by too little to
// show end to end (PERF.md).
// The kk chosen keys are compacted
// into shared memory, sorted by rank (each key counts the chosen keys
// above it), and written to the candidate buffer (planes, tiles, cap),
// cap = min(k, pixels of a full tile of this plane), with 0 after the last.
//
// Phase 2, topk_merge_kernel, one block of 256 threads a plane: every
// candidate finds its rank in the plane as the number of keys above it in
// every tile's list (in its own, its position): a branchless binary search
// of each descending list, four lists at a time so their loads overlap. A
// candidate of rank r < k writes output r. No rounds, no chain of
// dependent reductions. The lists are staged in shared memory when they
// fit in 48 KiB (every serving shape), else read from L2.
//
// Why it is exact. An element of the plane's top k has fewer than k keys
// above it in the plane, so fewer than k in its own tile: it is in its
// tile's top min(k, valid pixels). So the candidates hold the plane's top k,
// and every key above a top-k key is a candidate too; its rank among the
// candidates is its rank in the plane, and every other candidate ranks k or
// lower. Each output slot 0 .. k - 1 is written exactly once.
//
// Two launches on the caller's stream, not one: the merge needs every tile
// of its plane, and a single launch would need a cluster a plane or a
// last-block-done counter that must be zeroed before each call. The gap
// between the two launches, read from a profiler trace, is reported by
// chip_smoke.py beside the two phases' times.
//
// The front is sigmoid_nms_front.cuh, shared with kernel A, so values and
// indices are bit-identical to the plain PyTorch version on the same card.

#include <algorithm>
#include <cuda_runtime.h>

#include "sigmoid_nms_front.cuh"

using namespace sdnet;

namespace {
using u64 = unsigned long long;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kKeys = kStripRows;             // keys a thread holds
constexpr int kTilePixels = kTileW * kTileH;  // 2048
constexpr int kWarps = kFrontThreads / 32;
constexpr int kDenseLanes = 8;  // lanes in play above which a warp aggregates
constexpr int kMergeThreads = 256;
constexpr int kMergeLists = 4;  // lists a thread searches at once
constexpr size_t kMergeStagedBytes = 48 * 1024;  // no opt-in attribute needed

__device__ __forceinline__ u64 pack(float v, int flat) {
  return (static_cast<u64>(__float_as_uint(v)) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(flat));
}

__device__ __forceinline__ unsigned warp_exclusive_sum(unsigned v, int lane) {
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  return incl - v;
}

// The selection's state, in shared memory: the keys in play are those
// whose bytes so far (under the caller's mask) equal `prefix`; `need` of
// them are still to be taken, and `done` once they are all of them.
struct Selection {
  u64 prefix;
  unsigned need, done;
  unsigned count;  // keys in `chosen`
};

// Warp 0 after a 256-bin histogram of the byte at `shift`: pick the bin that
// holds the need-th largest key in play, from the top.
__device__ __forceinline__ void pick_bin(const unsigned* bins, int shift,
                                         int lane, Selection& sel) {
  // lane l holds bins 255 - 8l down to 248 - 8l
  unsigned cnt[8], total = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    cnt[q] = bins[255 - 8 * lane - q];
    total += cnt[q];
  }
  // every lane reads `need` before one lane writes it
  const unsigned need = sel.need;
  unsigned above = warp_exclusive_sum(total, lane);
  __syncwarp();
  if (above < need && need <= above + total) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (need <= above + cnt[q]) {
        sel.prefix |= static_cast<u64>(255 - 8 * lane - q) << shift;
        sel.need = need - above;
        sel.done = cnt[q] == need - above;  // the bin is taken whole
        break;
      }
      above += cnt[q];
    }
  }
}

__global__ void __launch_bounds__(kFrontThreads)
    topk_tiles_kernel(const float* __restrict__ x, u64* __restrict__ cand,
                      int h, int w, int tiles_x, int tiles, int cap,
                      int k) {
  // the staged sigmoid tile, then (once every thread holds its keys) the
  // tile's chosen keys
  __shared__ __align__(16) unsigned char raw[kTilePixels * sizeof(u64)];
  __shared__ unsigned hist[2][256];  // one to count into, one to clear
  __shared__ unsigned s_bins[kWarps][12];
  __shared__ Selection sel;

  const int plane = blockIdx.x / tiles;
  const int tile = blockIdx.x - plane * tiles;
  const int oy = (tile / tiles_x) * kTileH;
  const int ox = (tile % tiles_x) * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  float* s = reinterpret_cast<float*>(raw);
  stage_tile(x + static_cast<size_t>(plane) * h * w, s, oy, ox, h, w);
  for (int b = tid; b < 256; b += kFrontThreads) hist[0][b] = 0;
  if (tid == 0) {
    sel.prefix = 0;
    sel.need = min(k, min(kTileH, h - oy) * min(kTileW, w - ox));
    sel.done = 0;
    sel.count = 0;
  }
  __syncthreads();

  u64 key[kKeys];
  const int gx = ox + threadIdx.x;
  const int gy0 = oy + threadIdx.y * kStripRows;
  suppress_tile(s, [&](int i, float v) {
    const int gy = gy0 + i;
    key[i] = (gy < h && gx < w) ? pack(v, gy * w + gx) : 0ull;
  });
  const unsigned kk = sel.need;  // keys this tile keeps
  u64* chosen = reinterpret_cast<u64*>(raw);  // once the tile is read

  // Select the tile's kk largest keys (key 0, a cell past the edge, is
  // never in play) by a radix select, one byte a pass from the top, until
  // the bin that holds the kk-th key is taken whole.
  //
  // Pass 1, the value's top byte, takes 12 values only (0 for a zero,
  // 0x35 .. 0x3F for [1e-6, 1 - 1e-6]), and nearly every key shares one of
  // two, so it is counted without atomics: per thread in ten-bit fields of
  // two registers, summed over the warp by shuffles.
  {
    u64 lo = 0, hi = 0;  // bins 0-5 and 6-11, ten bits each
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const unsigned byte = static_cast<unsigned>(key[j] >> 56);
      const unsigned bin = byte ? byte - 0x34u : 0u;
      const u64 one = key[j] ? 1ull : 0ull;
      if (bin < 6) {
        lo += one << (10 * bin);
      } else {
        hi += one << (10 * (bin - 6));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(kFullMask, lo, off);
      hi += __shfl_xor_sync(kFullMask, hi, off);
    }
    if (lane < 12) {
      const u64 f = lane < 6 ? lo >> (10 * lane) : hi >> (10 * (lane - 6));
      s_bins[warp][lane] = static_cast<unsigned>(f) & 1023u;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int bin = 11 - lane;  // lane 0 holds the top bin
    unsigned cnt = 0;
    if (bin >= 0) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) cnt += s_bins[v][bin];
    }
    // every lane reads `need` before one lane writes it
    const unsigned need = sel.need;
    const unsigned above = warp_exclusive_sum(cnt, lane);
    __syncwarp();
    if (above < need && need <= above + cnt) {
      sel.prefix = static_cast<u64>(bin ? bin + 0x34 : 0) << 56;
      sel.need = need - above;
      sel.done = cnt == need - above;
    }
  }
  __syncthreads();
  // every key above the pass-1 bin is taken; the bin is taken whole if done
  const u64 mask1 = 0xFFull << 56;
  const u64 prefix1 = sel.prefix;
  const bool done1 = sel.done;

  if (!done1) {
    // Passes 2-4 over the value's other bytes on a 256-bin histogram; a
    // warp whose slot has many keys in play (a plateau) aggregates equal
    // digits before its atomics.
    u64 mask = mask1;
    for (int shift = 48, cur = 0; shift >= 32 && !sel.done; shift -= 8, cur ^= 1) {
      for (int b = tid; b < 256; b += kFrontThreads) hist[cur ^ 1][b] = 0;
      const u64 prefix = sel.prefix;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const bool in = key[j] != 0 && (key[j] & mask) == prefix;
        const unsigned ins = __ballot_sync(kFullMask, in);
        if (!ins) continue;
        const unsigned digit = static_cast<unsigned>(key[j] >> shift) & 255u;
        if (__popc(ins) > kDenseLanes) {
          const unsigned peers = __match_any_sync(kFullMask, in ? digit : 256u);
          if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[cur][digit], __popc(peers));
        } else if (in) {
          atomicAdd(&hist[cur][digit], 1u);
        }
      }
      __syncthreads();
      if (warp == 0) pick_bin(hist[cur], shift, lane, sel);
      __syncthreads();
      mask |= 0xFFull << shift;
    }
    // A tie at the kk-th value: the tied keys in row-major order (warp,
    // key slot, lane), which is flat-index order, by ballots.
    const u64 prefix = sel.prefix;
    const bool tie = !sel.done;
    const unsigned tie_need = sel.need;
    unsigned tie_rank = 0;  // tied keys before this warp's
    if (tie) {
      unsigned eq_count = 0;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        eq_count += __popc(__ballot_sync(kFullMask, key[j] != 0 && (key[j] & mask) == prefix));
      }
      if (lane == 0) s_bins[warp][0] = eq_count;
      __syncthreads();
      for (int v = 0; v < warp; ++v) tie_rank += s_bins[v][0];
    }
    // the keys at or above the prefix of the value (the tied ones by rank)
    // join those above the pass-1 bin below
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const u64 mk = key[j] & mask;
      bool t = key[j] != 0 && (key[j] & mask1) == prefix1 && mk >= prefix;
      if (tie) {
        const bool eq = key[j] != 0 && mk == prefix;
        const unsigned eqs = __ballot_sync(kFullMask, eq);
        if (eq) t = tie_rank + __popc(eqs & lt) < tie_need;
        tie_rank += __popc(eqs);
      }
      const unsigned b = __ballot_sync(kFullMask, t);
      unsigned at = 0;
      if (lane == 0 && b) at = atomicAdd(&sel.count, __popc(b));
      at = __shfl_sync(kFullMask, at, 0);
      if (t) chosen[at + __popc(b & lt)] = key[j];
    }
  }

  // The keys above the pass-1 bin (and the bin itself when it is taken
  // whole), compacted: one atomic a warp.
  bool take[kKeys];
  unsigned taken = 0;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const u64 mk = key[j] & mask1;
    take[j] = key[j] != 0 && (done1 ? mk >= prefix1 : mk > prefix1);
    taken += __popc(__ballot_sync(kFullMask, take[j]));
  }
  unsigned base = 0;
  if (lane == 0 && taken) base = atomicAdd(&sel.count, taken);
  base = __shfl_sync(kFullMask, base, 0);
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const unsigned b = __ballot_sync(kFullMask, take[j]);
    if (take[j]) chosen[base + __popc(b & lt)] = key[j];
    base += __popc(b);
  }
  __syncthreads();

  // Sorted by rank: the chosen keys are unique.
  u64* out = cand + static_cast<size_t>(blockIdx.x) * cap;
  for (int i = tid; i < static_cast<int>(kk); i += kFrontThreads) {
    const u64 v = chosen[i];
    int r = 0;
    for (int j = 0; j < static_cast<int>(kk); ++j) r += chosen[j] > v;
    out[r] = v;
  }
  for (int r = static_cast<int>(kk) + tid; r < cap; r += kFrontThreads) out[r] = 0;
}

__global__ void __launch_bounds__(kMergeThreads)
    topk_merge_kernel(const u64* __restrict__ cand, float* __restrict__ vals,
                      int* __restrict__ inds, int tiles, int cap, int k,
                      int staged) {
  extern __shared__ u64 s_cand[];
  const int plane = blockIdx.x;
  const int n = tiles * cap;
  const u64* c = cand + static_cast<size_t>(plane) * n;
  if (staged) {
    for (int e = threadIdx.x; e < n; e += kMergeThreads) s_cand[e] = c[e];
    __syncthreads();
    c = s_cand;
  }
  int top = 1;  // the largest power of two <= cap
  while (2 * top <= cap) top *= 2;
  float* out_v = vals + static_cast<size_t>(plane) * k;
  int* out_i = inds + static_cast<size_t>(plane) * k;
  for (int e = threadIdx.x; e < n; e += kMergeThreads) {
    const u64 v = c[e];
    if (v == 0) continue;  // an unused slot
    // rank of v: the keys above it in every list (in its own list, its
    // position). Each list descends, then zeros: a branchless binary
    // search, four lists at a time so their loads overlap.
    int r = 0;
    for (int u0 = 0; u0 < tiles && r < k; u0 += kMergeLists) {
      int pos[kMergeLists] = {};
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int j = 0; j < kMergeLists; ++j) {
          const int p = pos[j] + step;
          if (u0 + j < tiles && p <= cap && c[(u0 + j) * cap + p - 1] > v) pos[j] = p;
        }
      }
#pragma unroll
      for (int j = 0; j < kMergeLists; ++j) r += pos[j];
    }
    if (r < k) {
      out_v[r] = __uint_as_float(static_cast<unsigned>(v >> 32));
      out_i[r] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(v));
    }
  }
}

// Kernel B's tiling of an (h, w) plane for top-k: the tiles, and the
// slots each keeps in the candidate buffer (its best min(k, pixels of a
// full tile of this plane)).
struct Grid {
  int tiles_x, tiles, cap;
};

Grid grid_of(int h, int w, int k) {
  const int tiles_x = (w + kTileW - 1) / kTileW;
  return {tiles_x, (h + kTileH - 1) / kTileH * tiles_x,
          std::min(k, std::min(h, kTileH) * std::min(w, kTileW))};
}

}  // namespace

// The int64 slots of the candidate buffer that one (h, w) plane needs for
// top-k; the caller allocates planes times this many.
extern "C" int sdnet_topk_candidate_slots(int h, int w, int k) {
  const Grid g = grid_of(h, w, k);
  return g.tiles * g.cap;
}

// x: `planes` contiguous (h, w) float32 planes; cand a buffer of planes *
// sdnet_topk_candidate_slots(h, w, k) uint64 (phase 1 writes every slot);
// vals (planes, k) float32 and inds (planes, k) int32 outputs. Launches
// both phases on `stream` and returns cudaGetLastError() after each.
extern "C" int sdnet_sigmoid_nms_topk(const void* x, void* cand, void* vals,
                                      void* inds, int planes, int h, int w,
                                      int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g = grid_of(h, w, k);
  topk_tiles_kernel<<<g.tiles * planes, dim3(kTileW, kStrips), 0, st>>>(
      static_cast<const float*>(x), static_cast<u64*>(cand), h, w, g.tiles_x,
      g.tiles, g.cap, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(g.tiles) * g.cap * sizeof(u64);
  const int staged = bytes <= kMergeStagedBytes;
  topk_merge_kernel<<<planes, kMergeThreads, staged ? bytes : 0, st>>>(
      static_cast<const u64*>(cand), static_cast<float*>(vals),
      static_cast<int*>(inds), g.tiles, g.cap, k, staged);
  err = cudaGetLastError();
  return static_cast<int>(err);
}
