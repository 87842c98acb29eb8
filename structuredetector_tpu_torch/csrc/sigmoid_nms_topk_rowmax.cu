// Kernel C: clamped sigmoid + 5x5 plateau NMS + top-k through a table of
// run maxima, one thread-block cluster a plane.
//
// Replaces structuredetector_tpu/ops/pallas/topk.py::
// _sigmoid_nms_topk_onehot_kernel (fused_sigmoid_nms_topk,
// variant="onehot"). Same function as kernel B (sigmoid_nms_topk.cu): values
// and flat indices y * W + x of the k largest suppressed values, ties to the
// smallest flat index, the zeros of the plane in ascending index order when
// it has fewer than k peaks. Same route as the Pallas variant, not kernel B's
// radix select: a table of maxima, the winning entry, a rescan of only that
// stretch of the plane, and a repair of one table entry.
//
// What bounds it on an H100: bytes, on the roofline, as kernel B: one read
// of the logits (6.3 MB for the anchor and part planes of a batch of 32,
// 0.00188 ms at 3.35 TB/s) and k values and indices out. In practice the
// chain of k dependent selection rounds sets the time (latency, not a
// rate), after a front that reads the plane once.
//
// What the design does about it. One launch, a cluster of 8 blocks (of
// 32 x 4 threads) a plane, and nothing but the outputs leaves the chip:
// - Front. Tile t (32 wide, 64 tall) of the plane goes to the block of
//   cluster rank t % 8, which runs the tiled front of
//   sigmoid_nms_front.cuh on it, as kernels A and B do, so the three cannot
//   drift apart. A 128 x 128 plane is one tile a block: a batch of 32
//   launches 512 blocks for its anchor planes, 256 for its part planes. The
//   block keeps the suppressed values in its own shared memory, in slot
//   t / 8, rows at a pitch of min(W, 32): a thin plane (65536 x 1) costs 64
//   pixels a slot, not a 64 x 32 tile.
// - Table. Entry s is the max of the 32-pixel run of flat indices
//   [32 s, 32 s + 32): at most 2048 entries (8 KiB) for any plane the
//   wrapper takes, whatever its shape, held in rank 0's shared memory. A
//   warp reads back the rows it has just written, two lanes a row, and one
//   lane a row folds the row's maxima into rank 0's table by atomicMax
//   through distributed shared memory (DSMEM): a row touches at most two
//   runs, and a run may cross a row end or a tile border when W % 32 != 0.
//   (One redux.sync a row was slower: each writes the same uniform
//   register, so a warp's 16 ran one after another.)
// - Rounds. After cluster.sync, warp 0 of rank 0 runs the k rounds alone.
//   Lane l caches the best (max, smallest run) of its slice of the table,
//   a power-of-two stretch of entries. A round: the winning run (redux max,
//   then redux min of the runs that hold it); one DSMEM load a lane reads
//   the run's 32 values from whichever block owns each pixel (lane = offset
//   in the run, so the lane that masks a pixel is the lane that reads it in
//   every later round); the winning column (the lowest lane holding the
//   max) and the run's max without it, side by side; the mask stored into
//   the owner's shared memory; the run's entry rewritten; and the best of
//   the run's slice renewed from a rescan of the slice's other entries by
//   the whole warp while the DSMEM load is in flight.
// - Every block calls cluster.sync once more before it exits: rank 0 reads
//   the others' shared memory until its last round.
// What holds it now: a round is one warp's chain of dependent instructions
// (two warp reductions, the pixel's address, a DSMEM load, the column),
// with no other warp to hide a latency behind. Keeping the last run's
// values, or reading the runner-up's run one round ahead, put more
// instructions on that chain than the load they saved (PERF.md).
//
// Why the run-keyed table is exact. The runs split the flat index range
// into consecutive stretches, so the smallest run whose max is the plane's
// max, and then the smallest offset in it holding that value, is the
// smallest flat index holding the max. That is the selection order of
// kernel B and of the plain version.
//
// Order as integers. A suppressed value is 0 or lies in [1e-6, 1 - 1e-6],
// so its bits order as a signed int. One sentinel, -1, stands below all of
// them: a taken pixel, a lane past the plane's last pixel, a table entry
// before the front.

#include <cooperative_groups.h>

#include <climits>
#include <cuda_runtime.h>

#include "sigmoid_nms_front.cuh"

namespace cg = cooperative_groups;
using namespace sdnet;

namespace {

constexpr int kCluster = 8;   // blocks a plane: the portable cluster size
constexpr int kRun = 32;      // pixels a table entry covers: one a lane
constexpr int kMasked = -1;   // below the bits of every suppressed value
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 227 * 1024;  // a block's opt-in limit
// Blocks an SM must hold (96 registers a thread, no spills). The 64 anchor
// planes of a batch of 32 are 64 clusters; at 4 blocks an SM an NVIDIA
// H100 80GB HBM3 (700 W) held 62 at once (cudaOccupancyMaxActiveClusters),
// so a second wave ran after the first; at 5 it holds 77.
constexpr int kMinBlocks = 5;

// Where a plane lives in the cluster: tile t in slot t / kCluster of rank
// t % kCluster, its rows at a pitch of slot_w.
struct Layout {
  int tiles_x, tiles;
  int slot_w, slot_px;  // min(w, kTileW); min(h, kTileH) * slot_w
  int slots;            // slots a block holds
  int runs;             // table entries in use
  int table;            // table entries held: runs, to a multiple of 4
};

Layout layout_of(int h, int w) {
  Layout L;
  L.tiles_x = (w + kTileW - 1) / kTileW;
  L.tiles = (h + kTileH - 1) / kTileH * L.tiles_x;
  L.slot_w = w < kTileW ? w : kTileW;
  L.slot_px = (h < kTileH ? h : kTileH) * L.slot_w;
  L.slots = (L.tiles + kCluster - 1) / kCluster;
  L.runs = (h * w + kRun - 1) / kRun;
  L.table = (L.runs + 3) / 4 * 4;
  return L;
}

size_t shared_bytes(const Layout& L) {
  return (kStageFloats + L.table + static_cast<size_t>(L.slots) * L.slot_px) *
         sizeof(float);
}

// The best (max, smallest run) of table[lo, hi); INT_MIN when empty. The
// table is 16-byte aligned and lo a multiple of 4: 16-byte loads.
__device__ __forceinline__ void scan_slice(const int* table, int lo, int hi,
                                           int& best_v, int& best_s) {
  best_v = INT_MIN;
  best_s = lo;
  for (int q = lo; q < hi; q += 4) {
    const int4 e = *reinterpret_cast<const int4*>(table + q);
    const int v[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (q + j < hi && v[j] > best_v) {  // strict: the smallest run keeps a tie
        best_v = v[j];
        best_s = q + j;
      }
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kFrontThreads, kMinBlocks)
    rowmax_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int* __restrict__ inds, int h, int w, int k, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  int* table = reinterpret_cast<int*>(stage + kStageFloats);  // used on rank 0
  int* sup = table + L.table;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int plane = blockIdx.x / kCluster;
  const int n = h * w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = threadIdx.x;
  const float* xp = x + static_cast<size_t>(plane) * n;
  int* table0 = cluster.map_shared_rank(table, 0);

  if (rank == 0) {
    for (int s = tid; s < L.table; s += kFrontThreads) table[s] = kMasked;
  }
  int t = rank;
  auto origin = [&](int tile, int& oy, int& ox) {
    oy = (tile / L.tiles_x) * kTileH;
    ox = (tile % L.tiles_x) * kTileW;
  };
  int oy, ox;
  origin(t, oy, ox);
  if (t < L.tiles) stage_tile(xp, stage, oy, ox, h, w);
  // every block has started (DSMEM), the table is set before any atomicMax,
  // and the first tile is staged
  cluster.sync();

  while (t < L.tiles) {
    int* slot = sup + (t / kCluster) * L.slot_px;
    const int gx = ox + lane;
    const int gy0 = oy + threadIdx.y * kStripRows;
    const bool in_col = gx < w;
    const int row_end = min(ox + kTileW, w) - 1;  // the tile row's last column
    suppress_tile(stage, [&](int i, float v) {
      if (in_col && gy0 + i < h) slot[(gy0 + i - oy) * L.slot_w + lane] = __float_as_int(v);
    });
    __syncwarp();  // the warp reads back the rows it wrote
    // The run maxima of the strip's rows, read back from the slot: lanes 2i
    // and 2i + 1 take row i's columns 0-15 and 16-31, rotated by i so the
    // warp's 32 loads fall in 32 banks. The row's columns ox .. row_end
    // touch runs s_lo and s_hi (equal when W % 32 == 0); those of s_lo are
    // the columns below 32 - (first flat index) % 32.
    const int row = lane >> 1, half = (lane & 1) * (kTileW / 2);
    const int gy = gy0 + row;
    const int first = gy * w + ox, cut = kRun - first % kRun, cols = row_end - ox + 1;
    const int* line = slot + (gy - oy) * L.slot_w;
    int lo_max = kMasked, hi_max = kMasked;
    if (gy < h) {
#pragma unroll
      for (int j = 0; j < kTileW / 2; ++j) {
        const int c = half + ((j + row) & (kTileW / 2 - 1));
        if (c < cols) {
          const int b = line[c];
          if (c < cut) {
            lo_max = max(lo_max, b);
          } else {
            hi_max = max(hi_max, b);
          }
        }
      }
    }
    lo_max = max(lo_max, __shfl_xor_sync(kFullMask, lo_max, 1));
    hi_max = max(hi_max, __shfl_xor_sync(kFullMask, hi_max, 1));
    if (half == 0 && gy < h) {
      const int s_lo = first / kRun, s_hi = (gy * w + row_end) / kRun;
      atomicMax(table0 + s_lo, lo_max);
      if (s_hi != s_lo) atomicMax(table0 + s_hi, hi_max);
    }
    t += kCluster;
    if (t >= L.tiles) break;
    origin(t, oy, ox);
    __syncthreads();  // the stage is read
    stage_tile(xp, stage, oy, ox, h, w);
    __syncthreads();
  }
  // every slot and every table entry is written
  cluster.sync();

  if (rank == 0 && tid < 32) {
    // lane l caches the best of table entries [l << shift, (l + 1) << shift):
    // a power of two, so the slice of a run is a shift away, and at least 4,
    // for scan_slice's 16-byte loads
    int shift = 2;
    while ((32 << shift) < L.runs) ++shift;
    int best_v, best_s;
    scan_slice(table, min(lane << shift, L.runs), min((lane + 1) << shift, L.runs), best_v,
               best_s);
    const float inv_w = 1.0f / w;
    float* out_v = vals + static_cast<size_t>(plane) * k;
    int* out_i = inds + static_cast<size_t>(plane) * k;
    for (int r = 0; r < k; ++r) {
      // the winning run: the max, then the smallest run holding it (slices
      // ascend with the lane)
      const int top = __reduce_max_sync(kFullMask, best_v);
      const int s = __reduce_min_sync(kFullMask, best_v == top ? best_s : INT_MAX);
      // its 32 values, one DSMEM load a lane
      const int p = s * kRun + lane;
      int v = kMasked;
      int* at = nullptr;
      if (p < n) {
        // p / w from the reciprocal: within one of the quotient, then exact
        int y = __float2int_rz(__int2float_rn(p) * inv_w);
        int c = p - y * w;
        if (c < 0) {
          --y;
          c += w;
        } else if (c >= w) {
          ++y;
          c -= w;
        }
        const unsigned uy = y, uc = c;
        const unsigned tile = (uy / kTileH) * L.tiles_x + uc / kTileW;
        at = cluster.map_shared_rank(sup, tile % kCluster) +
             (tile / kCluster) * L.slot_px + (uy % kTileH) * L.slot_w + uc % kTileW;
        v = *at;
      }
      // while the load is in flight, the whole warp rescans the slice that
      // holds run s but for run s (its other entries do not change this
      // round): the max, then the smallest run
      const int owner = s >> shift;
      const int lo = owner << shift, hi = min(lo + (1 << shift), L.runs);
      int slice_v = INT_MIN, slice_s = INT_MAX;
      for (int e = lo + lane; e < hi; e += 32) {
        const int te = e == s ? INT_MIN : table[e];
        if (te > slice_v) {
          slice_v = te;
          slice_s = e;
        }
      }
      const int other_v = __reduce_max_sync(kFullMask, slice_v);
      const int other_s = __reduce_min_sync(kFullMask, slice_v == other_v ? slice_s : INT_MAX);
      // the winning column, the lowest lane holding the max, and the run's
      // max without it: the max again if another lane holds it, else the
      // max of the lanes below it
      const unsigned tops = __ballot_sync(kFullMask, v == top);
      const int below = __reduce_max_sync(kFullMask, v == top ? kMasked : v);
      const int col = __ffs(tops) - 1;
      const int rest = (tops & (tops - 1)) ? top : below;
      if (lane == col) *at = kMasked;
      if (lane == owner) {  // the slice's new best
        const bool run_s = rest > other_v || (rest == other_v && s < other_s);
        best_v = run_s ? rest : other_v;
        best_s = run_s ? s : other_s;
      }
      if (lane == 0) {
        table[s] = rest;
        out_v[r] = __int_as_float(top);
        out_i[r] = s * kRun + col;
      }
      __syncwarp();  // any lane may read table[s] in a later round
    }
  }
  // rank 0 reads the other blocks' shared memory until its last round
  cluster.sync();
}

}  // namespace

// x: `planes` contiguous (h, w) float32 planes, h * w <= 65536; vals
// (planes, k) float32 and inds (planes, k) int32 outputs. One launch of
// planes * 8 blocks in clusters of 8 on `stream`; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int sdnet_sigmoid_nms_topk_rowmax(const void* x, void* vals,
                                             void* inds, int planes, int h,
                                             int w, int k, void* stream) {
  const Layout L = layout_of(h, w);
  const size_t bytes = shared_bytes(L);
  if (bytes > kMaxSharedBytes || L.runs > 2048) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      rowmax_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rowmax_topk_kernel<<<planes * kCluster, dim3(kTileW, kStrips), bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals),
      static_cast<int*>(inds), h, w, k, L);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the kernel the card can hold at once for a launch
// of `planes` (h, w) planes (cudaOccupancyMaxActiveClusters); a negative
// CUDA error code on failure.
extern "C" int sdnet_rowmax_active_clusters(int planes, int h, int w) {
  const Layout L = layout_of(h, w);
  const size_t bytes = shared_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      rowmax_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(planes * kCluster);
  config.blockDim = dim3(kTileW, kStrips);
  config.dynamicSmemBytes = bytes;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, rowmax_topk_kernel, &config);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}
