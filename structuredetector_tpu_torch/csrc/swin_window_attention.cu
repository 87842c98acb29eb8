// The Swin V2 attention core of one block, in one launch: from the
// (B, H, W, 3C) output of the qkv Linear to the (B, H, W, C) input of proj.
//
// It replaces no TPU kernel (the JAX package's Swin-free encoders have no
// attention). It was added because this core held 60 % of the card's busy
// time in the Swin V2-B inference benchmark cell: the plain PyTorch chain
// (pad, roll, a window partition copy, two normalize passes, the position
// bias plus mask expanded over every window of the batch, an attention on
// its math path, a reverse copy, a roll back, a crop) makes a full pass over
// device memory at each step.
//
// Function (ops/kernels/swin_window_attention.py::window_attention_reference):
// window 8 x 8 tokens, head dim 32. Token (i, j) of window (wh, ww) reads
// its row at ((8 wh + i + sh) mod hp, (8 ww + j + sw) mod wp) of the map
// padded to (hp, wp); a row at or beyond (h, w) is padding and takes the
// qkv bias. q and k are L2-normalized in fp32 (eps 1e-12), q times
// exp(min(logit_scale, ln 100)) of its head; scores q k^T + position bias
// of the head + -100 between tokens of different regions of a shifted
// edge window (torchvision's region ids, recomputed from the window's
// position); softmax in fp32; times v. Each token's output goes back to
// the row it was read from (the shift undone), except padding.
//
// What bounds it on an H100: bytes. q, k and v are read once and the
// output written once (8 bytes of bf16 a channel of a token); the two
// 64 x 64 x 32 products are 32 FLOP a byte, far below the card's ~295.
// What the design does about it: nothing between the two tensors goes
// through device memory. The pad, shift, partition, reverse and crop are
// index arithmetic on the loads and stores; the position bias sits in
// registers for the block's whole life (one head a block) and the mask is
// recomputed from the window's position. A block of 4 warps walks a run
// of windows of one head, with the next window's q, k and v in flight
// (cp.async, 16 bytes a thread, into a second buffer) while it computes
// the current one, so a few blocks an SM keep enough bytes in flight.
// Neighbouring blocks take neighbouring heads of the same windows, so
// together they read whole lines of each token's row. The products run
// on the tensor cores (mma.sync m16n8k16 bf16, fp32 accumulators; a warp
// owns 16 query rows, so the softmax needs only quad shuffles and the
// scores turn into the second product's A fragments in registers); the
// output goes through the warp's own q rows in shared memory so that it
// leaves as 16-byte stores.
//
// float32 inputs take a plain kernel with fp32 FMAs (no TF32), one block a
// (window, head): the port's float32 training and tests.
//
// Deterministic: no atomics, and every reduction (shuffles, sums over
// keys) runs in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWin = 8;
constexpr int kTokens = kWin * kWin;
constexpr int kHeadDim = 32;
constexpr int kThreads = 128;
constexpr int kRow = 40;  // bf16 a shared row: 64 bytes + 16 of padding
constexpr int kTile = kTokens * kRow;
constexpr int kStage = 3 * kTile;  // q, k, v of one window
constexpr int kTargetBlocks = 2048;
constexpr float kLogitScaleMax = 4.605170185988091f;  // ln 100
constexpr float kMaskValue = -100.0f;
constexpr float kNormEps = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int h, w, c;
  int hp, wp, nwh, nww;
  int sh, sw;
  int windows;  // b * nwh * nww
};

struct Window {
  int b, wh, ww;
  int rid_h, rid_w;  // a token's row (col) in the window at or past these is
                     // in the second region of a shifted edge window
};

__device__ __forceinline__ Window window_of(const Geometry& g, int win) {
  Window v;
  const int per_image = g.nwh * g.nww;
  v.b = win / per_image;
  const int r = win - v.b * per_image;
  v.wh = r / g.nww;
  v.ww = r - v.wh * g.nww;
  v.rid_h = (g.sh && v.wh == g.nwh - 1) ? kWin - g.sh : kWin;
  v.rid_w = (g.sw && v.ww == g.nww - 1) ? kWin - g.sw : kWin;
  return v;
}

// The token's row of the (B, H, W) map, or -1 for padding.
__device__ __forceinline__ int64_t token_row(const Geometry& g, const Window& v,
                                             int t) {
  int sr = v.wh * kWin + (t >> 3) + g.sh;
  int sc = v.ww * kWin + (t & 7) + g.sw;
  if (sr >= g.hp) sr -= g.hp;
  if (sc >= g.wp) sc -= g.wp;
  if (sr >= g.h || sc >= g.w) return -1;
  return (static_cast<int64_t>(v.b) * g.h + sr) * g.w + sc;
}

__device__ __forceinline__ int region(const Window& v, int t) {
  return ((t >> 3) >= v.rid_h) * 2 + ((t & 7) >= v.rid_w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q, k and v of window `win`, head `head`, into `stage`: 3 x 64 token rows
// of 4 16-byte chunks, 6 a thread. Real tokens by cp.async, padding from
// the fp32 qkv bias.
__device__ __forceinline__ void load_window(const __nv_bfloat16* __restrict__ qkv,
                                            const float* __restrict__ qkv_bias,
                                            const Geometry& g, int win, int head,
                                            __nv_bfloat16* stage) {
  const Window v = window_of(g, win);
#pragma unroll
  for (int it = 0; it < 3 * kTokens * 4 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int part = idx >> 8, t = (idx >> 2) & 63, chunk = idx & 3;
    const int col = part * g.c + head * kHeadDim + chunk * 8;
    __nv_bfloat16* dst = stage + part * kTile + t * kRow + chunk * 8;
    const int64_t row = token_row(g, v, t);
    if (row >= 0) {
      cp_async16(dst, qkv + row * 3 * g.c + col);
    } else {
      const float4 lo = *reinterpret_cast<const float4*>(qkv_bias + col);
      const float4 hi = *reinterpret_cast<const float4*>(qkv_bias + col + 4);
      uint4 packed;
      packed.x = pack_bf16(lo.x, lo.y);
      packed.y = pack_bf16(lo.z, lo.w);
      packed.z = pack_bf16(hi.x, hi.y);
      packed.w = pack_bf16(hi.z, hi.w);
      *reinterpret_cast<uint4*>(dst) = packed;
    }
  }
}

// In place: rows 0..63 of q normalized and scaled, of k normalized; one
// row a thread, fp32, rounded back to bf16.
__device__ __forceinline__ void normalize_qk(__nv_bfloat16* stage, float scale) {
  const int t = threadIdx.x;
  uint4* row = reinterpret_cast<uint4*>(stage + (t >> 6) * kTile + (t & 63) * kRow);
  uint4 raw[4];
  float x[kHeadDim];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    raw[i] = row[i];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      x[8 * i + 2 * j] = f.x;
      x[8 * i + 2 * j + 1] = f.y;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kHeadDim; ++i) ss = fmaf(x[i], x[i], ss);
  const float f = (t < kTokens ? scale : 1.f) / fmaxf(sqrtf(ss), kNormEps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    raw[i].x = pack_bf16(x[8 * i] * f, x[8 * i + 1] * f);
    raw[i].y = pack_bf16(x[8 * i + 2] * f, x[8 * i + 3] * f);
    raw[i].z = pack_bf16(x[8 * i + 4] * f, x[8 * i + 5] * f);
    raw[i].w = pack_bf16(x[8 * i + 6] * f, x[8 * i + 7] * f);
    row[i] = raw[i];
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    window_attention_bf16(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ qkv_bias,
                          const __nv_bfloat16* __restrict__ pos_bias,
                          const float* __restrict__ logit_scale,
                          __nv_bfloat16* __restrict__ out, Geometry g,
                          int windows_per_block) {
  __shared__ __align__(16) __nv_bfloat16 smem[2 * kStage];
  const int head = blockIdx.x;
  const int first = blockIdx.y * windows_per_block;
  const int last = min(first + windows_per_block, g.windows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16 + gid;  // this thread's query rows: row0, row0 + 8
  const float scale = __expf(fminf(logit_scale[head], kLogitScaleMax));

  // the head's position bias at this thread's score fragment, for every window
  uint32_t bias[8][2];
  {
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(
        pos_bias + static_cast<size_t>(head) * kTokens * kTokens);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      bias[n][0] = pb[(row0 * kTokens + 8 * n + 2 * tig) >> 1];
      bias[n][1] = pb[((row0 + 8) * kTokens + 8 * n + 2 * tig) >> 1];
    }
  }

  load_window(qkv, qkv_bias, g, first, head, smem);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int win = first; win < last; ++win) {
    __nv_bfloat16* stage = smem + ((win - first) & 1) * kStage;
    if (win + 1 < last) {
      load_window(qkv, qkv_bias, g, win + 1, head, smem + ((win + 1 - first) & 1) * kStage);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    normalize_qk(stage, scale);
    __syncthreads();

    const __nv_bfloat16* qs = stage;
    const __nv_bfloat16* ks = stage + kTile;
    const __nv_bfloat16* vs = stage + 2 * kTile;

    // S = q k^T: 16 rows x 64 keys a warp
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);
    }
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * kRow + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // + bias (+ mask), softmax over the quad's 64 keys
    const Window v = window_of(g, win);
    const bool masked = v.rid_h < kWin || v.rid_w < kWin;
    const int rq0 = region(v, row0), rq1 = region(v, row0 + 8);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 b0 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bias[n][0]));
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bias[n][1]));
      s[n][0] += b0.x;
      s[n][1] += b0.y;
      s[n][2] += b1.x;
      s[n][3] += b1.y;
      if (masked) {
        const int k0 = region(v, 8 * n + 2 * tig), k1 = region(v, 8 * n + 2 * tig + 1);
        if (k0 != rq0) s[n][0] += kMaskValue;
        if (k1 != rq0) s[n][1] += kMaskValue;
        if (k0 != rq1) s[n][2] += kMaskValue;
        if (k1 != rq1) s[n][3] += kMaskValue;
      }
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float mb0 = m0 * kLog2e, mb1 = m1 * kLog2e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(fmaf(s[n][0], kLog2e, -mb0));
      s[n][1] = exp2f(fmaf(s[n][1], kLog2e, -mb0));
      s[n][2] = exp2f(fmaf(s[n][2], kLog2e, -mb1));
      s[n][3] = exp2f(fmaf(s[n][3], kLog2e, -mb1));
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }

    // O = P v: the score accumulators are the A fragments
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                                  16 * p + (lane >> 4) * 8);
        mma_bf16(acc[2 * p], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * p + 1], pa, vb[2], vb[3]);
      }
    }

    // the output through this warp's q rows, then 16-byte stores
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* os = stage + warp * 16 * kRow;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(os + gid * kRow + 8 * n + 2 * tig) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(os + (gid + 8) * kRow + 8 * n + 2 * tig) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int r = (lane >> 2) + 8 * it, chunk = lane & 3;
      const int64_t row = token_row(g, v, warp * 16 + r);
      if (row >= 0) {
        *reinterpret_cast<uint4*>(out + row * g.c + head * kHeadDim + chunk * 8) =
            *reinterpret_cast<const uint4*>(os + r * kRow + chunk * 8);
      }
    }
    __syncthreads();  // the next prefetch reuses this stage
  }
}

// float32, one (window, head): thread (row r, half) takes the keys
// 2 jj + half, and the pair adds its halves of the output.
__device__ __forceinline__ void attend_f32(const float* __restrict__ qkv,
                                           const float* __restrict__ qkv_bias,
                                           const float* __restrict__ pos_bias, float scale,
                                           float* __restrict__ out, const Geometry& g,
                                           int win, int head,
                                           float (&sm)[3][kTokens][kHeadDim + 1]) {
  const Window v = window_of(g, win);
  for (int idx = threadIdx.x; idx < 3 * kTokens * kHeadDim; idx += kThreads) {
    const int part = idx / (kTokens * kHeadDim), t = (idx / kHeadDim) % kTokens;
    const int col = part * g.c + head * kHeadDim + idx % kHeadDim;
    const int64_t row = token_row(g, v, t);
    sm[part][t][idx % kHeadDim] = row >= 0 ? qkv[row * 3 * g.c + col] : qkv_bias[col];
  }
  __syncthreads();
  {
    float* x = sm[threadIdx.x >> 6][threadIdx.x & 63];
    float ss = 0.f;
    for (int i = 0; i < kHeadDim; ++i) ss = fmaf(x[i], x[i], ss);
    const float denom = fmaxf(sqrtf(ss), kNormEps);
    const float mul = threadIdx.x < kTokens ? scale : 1.f;
    for (int i = 0; i < kHeadDim; ++i) x[i] = x[i] / denom * mul;
  }
  __syncthreads();

  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float q[kHeadDim];
#pragma unroll
  for (int i = 0; i < kHeadDim; ++i) q[i] = sm[0][r][i];
  const float* pb = pos_bias + (static_cast<size_t>(head) * kTokens + r) * kTokens;
  const int rq = region(v, r);
  float s[kTokens / 2];
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < kTokens / 2; ++jj) {
    const int j = 2 * jj + half;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kHeadDim; ++i) acc = fmaf(q[i], sm[1][j][i], acc);
    acc += pb[j];
    if (region(v, j) != rq) acc += kMaskValue;
    s[jj] = acc;
    m = fmaxf(m, acc);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float l = 0.f;
#pragma unroll
  for (int jj = 0; jj < kTokens / 2; ++jj) {
    s[jj] = expf(s[jj] - m);
    l += s[jj];
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  float o[kHeadDim];
#pragma unroll
  for (int i = 0; i < kHeadDim; ++i) o[i] = 0.f;
#pragma unroll
  for (int jj = 0; jj < kTokens / 2; ++jj) {
#pragma unroll
    for (int i = 0; i < kHeadDim; ++i) o[i] = fmaf(s[jj], sm[2][2 * jj + half][i], o[i]);
  }
#pragma unroll
  for (int i = 0; i < kHeadDim; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], 1);
  const int64_t row = token_row(g, v, r);
  if (row >= 0) {
    float* dst = out + row * g.c + head * kHeadDim + half * (kHeadDim / 2);
#pragma unroll
    for (int i = 0; i < kHeadDim / 2; ++i) dst[i] = (half ? o[kHeadDim / 2 + i] : o[i]) / l;
  }
  __syncthreads();  // the next window reuses the shared rows
}

__global__ void __launch_bounds__(kThreads)
    window_attention_f32(const float* __restrict__ qkv, const float* __restrict__ qkv_bias,
                         const float* __restrict__ pos_bias,
                         const float* __restrict__ logit_scale, float* __restrict__ out,
                         Geometry g) {
  __shared__ float sm[3][kTokens][kHeadDim + 1];
  const float scale = expf(fminf(logit_scale[blockIdx.x], kLogitScaleMax));
  for (int win = blockIdx.y; win < g.windows; win += gridDim.y) {
    attend_f32(qkv, qkv_bias, pos_bias, scale, out, g, win, blockIdx.x, sm);
  }
}

}  // namespace

// qkv: (b, h, w, 3c) contiguous, 16-byte aligned; qkv_bias: (3c) fp32;
// pos_bias: (heads, 64, 64) in qkv's type; logit_scale: (heads) fp32;
// out: (b, h, w, c) in qkv's type. dtype 0: float32, 1: bfloat16.
// c = heads * 32; (shift_h, shift_w) the block's shift on the padded map.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sdnet_swin_window_attention(const void* qkv, const void* qkv_bias,
                                           const void* pos_bias, const void* logit_scale,
                                           void* out, int dtype, int b, int h, int w, int c,
                                           int heads, int shift_h, int shift_w,
                                           void* stream) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.hp = (h + kWin - 1) / kWin * kWin;
  g.wp = (w + kWin - 1) / kWin * kWin;
  g.nwh = g.hp / kWin;
  g.nww = g.wp / kWin;
  g.sh = shift_h;
  g.sw = shift_w;
  g.windows = b * g.nwh * g.nww;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int per_block = std::max<int64_t>(
        1, (static_cast<int64_t>(g.windows) * heads + kTargetBlocks - 1) / kTargetBlocks);
    const dim3 grid(heads, (g.windows + per_block - 1) / per_block);
    window_attention_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(qkv_bias),
        static_cast<const __nv_bfloat16*>(pos_bias), static_cast<const float*>(logit_scale),
        static_cast<__nv_bfloat16*>(out), g, per_block);
  } else {
    const dim3 grid(heads, std::min(g.windows, 65535));
    window_attention_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(qkv_bias),
        static_cast<const float*>(pos_bias), static_cast<const float*>(logit_scale),
        static_cast<float*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}
