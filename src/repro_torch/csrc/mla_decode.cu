// Absorbed multi-head latent attention (MLA, DeepSeek-V2) decode for Hopper
// (sm_90a): one query token per (batch row, head) against the compressed
// latent cache, each batch row at its own length.
//
// No TPU kernel to replace: the reference computes this function in XLA
// einsums (src/repro/models/attention.py, apply_mla's decode branch, from
// q_abs to ctx).  For query head h of row b:
//
//   s[t] = (q_abs[b, h] . ckv[b, t] + q_rope[b, h] . krope[b, t]) * scale
//   p    = softmax(s over t < kv_len[b])
//   ctx  = sum_t p[t] ckv[b, t]
//
// in f32, the output in the input dtype.  All heads of a row read the same
// latent row (L + R values: 576 at kv_lora_rank 512, rope 64) and the values
// are the first L columns of the keys, the latent itself: that is MLA's
// memory saving (1,152 bytes a token a layer in bf16 against 65,536 for the
// same 128 heads in GQA), and what the kernels are built around.
//
// What bounds it on this card.  A row reads kv_len * (L + R) cache values
// once and does 2 * H * kv_len * (2L + R) FLOPs on them: at H = 128 about
// 240 FLOPs per bf16 byte.  That is far above the CUDA cores' ~20 (67
// TFLOP/s over 3.35 TB/s) but under the tensor cores' ~295 (989 TFLOP/s):
// on the tensor cores the cache's bytes bind (70.8 MB, 0.0215 ms, at B 4
// over kv_len 4096 ... 32768; the products alone 0.0173 ms).
//
// Three kernels, two launches a call:
//
//  * mla_wgmma_kernel (bf16, L 512, R 64: every DeepSeek MLA model): a
//    block holds 64 query heads of one row, one wgmma M-tile, so 128 heads
//    are two head chunks.  Q (64 x 576) and 64-key tiles of the latent (64
//    x 576) arrive by TMA in (64, 64) boxes under the 128-byte swizzle (9
//    boxes each: 8 of ckv, 1 of krope; keys past T read as zero).  The
//    tile is read once and serves twice, as K for S = Q K^T (36 steps of
//    wgmma m64n64k16, both operands from shared memory, K K-major) and its
//    first 512 columns as V for O += P V (V MN-major, P from registers).
//    Two warpgroups: the first computes S and the online softmax (exp2 of
//    the scaled score against the running max, P rounded to bf16, the sum
//    l unrounded) and hands P and the correction to the second through
//    shared memory (each thread's fragment at its own index: both hold the
//    same rows); each then multiplies P into its own 256 output columns, 64
//    x 256 f32 in 128 registers a thread.  Shared memory: Q 72 KB and two
//    stages of 72 KB, the next tile's copy in flight while one is used, P's
//    exchange 9 KB: 226 KB of the 227 a block may have, so one block an SM
//    and a grid of one wave.  Two stages of 64 keys rather than four of
//    32: the N = 64 products read each Q slice from shared memory half as
//    often per key, and 32-key tiles would double the softmax's and the
//    barriers' fixed costs per key.
//    The rows of the last, partly valid tile of a row are zeroed in shared
//    memory before P V reads them (a masked key's P is 0, but the cache past
//    kv_len may hold anything, and 0 * inf is not 0).
//    What holds it at ~2.6x its bound (H100, PERF.md §6): with two
//    stages a tile costs about (its load latency + its compute) / 2, and
//    the latency is each SM's TMA load rate, not the card's bandwidth (a
//    tile takes about as long to arrive with 8 blocks on the card).
//    Clusters of the two head chunks with TMA multicast (a tile leaves L2
//    once) and L2 prefetch two tiles ahead were tried and were no faster;
//    neither is kept.
//  * mla_decode_kernel (f32, and bf16 at other widths: the products on the
//    CUDA cores in f32; a TF32 pass keeps ~3 digits, short of the 3e-5
//    tolerance): 16 heads a block and 32-key tiles by cp.async; scores a
//    lane per key, P V a thread per two output columns.
//  * mla_merge_frag_kernel / mla_merge_kernel: the partials of each row
//    that more than one block touched, folded in block order; they also
//    write the zeros of a row with no valid key.  Launched as programmatic
//    dependents of the split kernel: their blocks start as its blocks
//    finish and wait for it before reading partials.
//
// The split is balanced over the batch, not per row.  The rows' valid key
// tiles are laid end to end and each of the nblocks blocks of a head chunk
// takes an equal share of them (ops.split_schedule is the same arithmetic
// in Python): every block reads kv_len on the device (spread over its
// threads), so the wrapper picks the grid from B, H, T and the SM count
// alone and never waits for the device.  A block walks its share row by
// row; where it holds all of a row it writes the output, otherwise it
// writes that row's partial (m in log2 units, l, acc, f32) to slot block +
// row, distinct for every (block, row); the tensor-core kernel writes acc
// in its threads' own layout, so that each warp's stores are 512
// contiguous bytes.  The merge is a launch of its own because one block
// merging a long row's partials would read them all through one SM: at B 4
// over kv_len 4096 ... 32768 the longest row has ~35 blocks, 4.6 MB of
// partials a head chunk.  Results do not depend on block order and no
// atomics touch data.  (m, l, acc) start at (-1e30, 0, 0) and the output is
// acc / max(l, 1e-30), so a row with kv_len 0 gives 0.  The kernels round
// exp(s - m) against the running max to bf16, the reference the
// normalised probability, so bf16 results differ by that rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// The split (ops.split_schedule)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int row_tiles(const int* kv_len, int b, int S, int keys) {
  return (min(max(kv_len[b], 0), S) + keys - 1) / keys;
}

// Block-wide sums and scans: every thread of the block calls them and gets
// the same result (blockDim.x a multiple of 32, at most 1024), so a block
// reads kv_len once, spread over its threads, whatever B is.
__device__ int block_sum(int v) {
  __shared__ int part[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // part is free again
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += part[w];
  return s;
}

// (tiles of all rows, tiles of rows [0, b))
__device__ int2 tiles_before(const int* kv_len, int B, int S, int keys, int b) {
  int total = 0, before = 0;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const int n = row_tiles(kv_len, j, S, keys);
    total += n;
    before += j < b ? n : 0;
  }
  return make_int2(block_sum(total), block_sum(before));
}

// A place in the rows' tiles laid end to end: tile t of row b, a row of n
// tiles.  Every thread of a block keeps the same.
struct Cursor {
  int b, t, n;
};

// the tile numbered g (< the total): the rows' tile counts scanned a
// block's width at a time up to the row that holds it
__device__ Cursor seek(const int* kv_len, int B, int S, int keys, int g) {
  __shared__ int warp_sum[32], hit[3];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (threadIdx.x == 0) hit[0] = -1;
  int base = 0;  // tiles of the rows before this chunk of rows
  for (int c0 = 0; c0 < B; c0 += blockDim.x) {
    const int j = c0 + threadIdx.x;
    const int n = j < B ? row_tiles(kv_len, j, S, keys) : 0;
    int incl = n;  // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    __syncthreads();  // warp_sum is free again; hit[0] is set
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    int chunk = 0;
    for (int v = 0; v < (int)blockDim.x / 32; ++v) {
      if (v < w) incl += warp_sum[v];
      chunk += warp_sum[v];
    }
    if (n > 0 && base + incl - n <= g && g < base + incl) {
      hit[0] = j;
      hit[1] = base + incl - n;
      hit[2] = n;
    }
    base += chunk;
    __syncthreads();
    if (hit[0] >= 0) break;
  }
  return Cursor{hit[0], g - hit[1], hit[2]};
}

// Programmatic dependent launch: the merge, launched with the attribute,
// may start once every block of the split kernel has called
// launch_dependents (or left), and read kv_len; every merge block then
// calls wait_prerequisites, which returns once the split kernel has
// finished and its writes are visible, so the merge also ends after it.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the next tile, past rows without one
__device__ void advance(Cursor& c, const int* kv_len, int B, int S, int keys) {
  if (++c.t < c.n) return;
  c.t = c.n = 0;
  while (c.n == 0 && ++c.b < B) c.n = row_tiles(kv_len, c.b, S, keys);
}

// ---------------------------------------------------------------------------
// bf16, L 512, R 64: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcHeads = 64;                 // query heads a block: one M-tile
constexpr int kTcKeys = 64;                  // keys a tile
constexpr int kTcL = 512, kTcR = 64;
constexpr int kSlice = 64 * 64;              // bf16 elements of a (64, 64) box
constexpr int kBoxes = (kTcL + kTcR) / 64;   // a row of Q or of the tile: 9 boxes
constexpr uint32_t kTileBytes = kBoxes * kSlice * 2;  // 73,728
constexpr int kTcThreads = 256;              // two warpgroups
// Q, two stages, P's exchange (16 words a thread of a warpgroup), a float2
// a thread, three mbarriers, and slack for 1024-byte alignment
constexpr int kTcSmem = 3 * kTileBytes + 16 * 128 * 4 + 128 * 8 + 3 * 8 + 1024;
static_assert(kTcSmem <= kMaxSmem, "shared memory");

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One block: head chunk blockIdx.x (heads [64 x, 64 x + 64) of H; those
// past H read as zero and are not written), share blockIdx.y of the tiles.
// Maps (width, rows, B), boxes (64, 64, 1): q (512, H, B), qr (64, H, B),
// ckv (512, S, B), krope (64, S, B).  out: (B, H, 512); part_ml: (chunks,
// nblocks + B, 64) float2 (m, l); part_acc: (chunks, nblocks + B) of 64 x
// 512 f32 in the threads' layout (32 float4 a thread, float4 q of thread t
// at q * 256 + t).
// Warpgroup 0 computes S and the softmax; both multiply P V.  The barriers:
// 0 = __syncthreads (end of a tile: its stage, P and the float2s are free),
// 1 = P handed over (warpgroup 0 arrives, 1 waits), 2 = warpgroup 0 alone.
__global__ void __launch_bounds__(kTcThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap qrmap,
                 const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap rmap,
                 const int* __restrict__ kv_len, bf16* __restrict__ out, float2* part_ml,
                 float* part_acc, int B, int H, int S, int nblocks, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* Ks0 = Qs + kBoxes * kSlice;                                 // stage s at s * kBoxes * kSlice
  uint4* Pb = reinterpret_cast<uint4*>(Ks0 + 2 * kBoxes * kSlice);  // [4][128]: P, a uint4 a k step
  float2* Cb = reinterpret_cast<float2*>(Pb + 4 * 128);             // [128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Cb + 128);           // q, full[2]

  const int hc = blockIdx.x, blk = blockIdx.y, h0 = hc * kTcHeads;
  const int total = tiles_before(kv_len, B, S, kTcKeys, 0).x;
  const int per = (total + nblocks - 1) / nblocks;
  const int g0 = min(total, blk * per), ntot = min(total, g0 + per) - g0;
  if (ntot <= 0) return;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, lane = tid % 32;
  const size_t nslot = (size_t)nblocks + B;

  auto issue_q = [&](int b) {
    mbar_expect_tx(&bars[0], kTileBytes);
#pragma unroll
    for (int x = 0; x < 8; ++x) tma_load_3d(Qs + x * kSlice, &qmap, &bars[0], x * 64, h0, b);
    tma_load_3d(Qs + 8 * kSlice, &qrmap, &bars[0], 0, h0, b);
  };
  auto issue_tile = [&](const Cursor& c, int stage) {
    bf16* Ks = Ks0 + stage * kBoxes * kSlice;
    mbar_expect_tx(&bars[1 + stage], kTileBytes);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      tma_load_3d(Ks + x * kSlice, &cmap, &bars[1 + stage], x * 64, c.t * kTcKeys, c.b);
    tma_load_3d(Ks + 8 * kSlice, &rmap, &bars[1 + stage], 0, c.t * kTcKeys, c.b);
  };

  Cursor cur = seek(kv_len, B, S, kTcKeys, g0);
  Cursor next = cur;  // thread 0: the next tile to load
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue_q(cur.b);
    for (int i = 0; i < 2 && i < ntot; ++i) {
      issue_tile(next, i);
      advance(next, kv_len, B, S, kTcKeys);
    }
  }

  // this thread's rows of the 64 heads: r and r + 8; its columns of each
  // 8-column block j of a 64-column slice: 8j + cq + {0, 1}
  const int r = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  float o[4][32];  // output columns [256 wg, 256 wg + 256) of rows r, r + 8
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // warpgroup 0; m in log2 units
  int seg = 0, seg_t0 = cur.t;  // segments (rows) begun, and this one's first tile

  for (int i = 0; i < ntot; ++i) {
    const int stage = i & 1;
    const bool seg_end = i == ntot - 1 || cur.t == cur.n - 1;
    const int nvalid = min(kTcKeys, min(max(kv_len[cur.b], 0), S) - cur.t * kTcKeys);
    bf16* Ks = Ks0 + stage * kBoxes * kSlice;
    mbar_wait(&bars[1 + stage], (i >> 1) & 1);
    uint32_t pa[4][4];  // P as the A operand, one 16-key step each
    float corr0, corr1;
    if (wg == 0) {
      if (nvalid < kTcKeys) {  // zero V's rows past kv_len
        for (int k = t; k < (kTcKeys - nvalid) * 8 * 8; k += 128) {
          const int x = k / ((kTcKeys - nvalid) * 8), rest = k % ((kTcKeys - nvalid) * 8);
          *reinterpret_cast<uint4*>(Ks + x * kSlice + (nvalid + rest / 8) * 64 + (rest % 8) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_sync(2, 128);
      }
      if (cur.t == seg_t0) mbar_wait(&bars[0], seg & 1);
      float sc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBoxes * 4; ++kk) {
        const int off = (kk / 4) * kSlice + (kk % 4) * 16;  // 32 bytes a k step, then the next box
        wgmma_ss(sc, desc_sw128(Qs + off, 16, 1024), desc_sw128(Ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (seg_end && i + 1 < ntot) {  // Q is read: load the next row's
        named_sync(2, 128);
        if (t == 0) {
          Cursor nx = cur;
          advance(nx, kv_len, B, S, kTcKeys);
          issue_q(nx.b);
        }
      }
      if (nvalid < kTcKeys) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (8 * j + cq + c >= nvalid) sc[4 * j + c] = sc[4 * j + 2 + c] = -INFINITY;
      }
      // the scale goes into the exponent: scale > 0, so the max of the
      // scaled scores is the scaled max
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      corr0 = ex2(m0 - mn0);
      corr1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p00 = ex2(fmaf(sc[4 * j], scale_log2, -mn0));
        const float p01 = ex2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
        const float p10 = ex2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
        const float p11 = ex2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Pb[k * 128 + t] = make_uint4(pa[k][0], pa[k][1], pa[k][2], pa[k][3]);
      Cb[t] = make_float2(corr0, corr1);
      named_arrive(1, kTcThreads);
    } else {
      named_sync(1, kTcThreads);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 x = Pb[k * 128 + t];
        pa[k][0] = x.x;
        pa[k][1] = x.y;
        pa[k][2] = x.z;
        pa[k][3] = x.w;
      }
      const float2 cc = Cb[t];
      corr0 = cc.x;
      corr1 = cc.y;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[s][4 * j] *= corr0;
        o[s][4 * j + 1] *= corr0;
        o[s][4 * j + 2] *= corr1;
        o[s][4 * j + 3] *= corr1;
      }
    // O += P V over this warpgroup's four 64-column boxes of ckv
    const bf16* Vs = Ks + 4 * wg * kSlice;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(o[s], pa[kk], desc_sw128(Vs + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_regs(o[s]);
    __syncthreads();  // the stage, P and the float2s are free
    if (tid == 0 && i + 2 < ntot) {
      issue_tile(next, stage);
      advance(next, kv_len, B, S, kTcKeys);
    }

    if (seg_end) {  // this block's part of row cur.b is done
      if (wg == 0) {
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, x);
          l1 += __shfl_xor_sync(0xffffffffu, l1, x);
        }
        Cb[t] = make_float2(l0, l1);
      }
      __syncthreads();
      const float2 ll = Cb[t];
      const bool whole = seg_t0 == 0 && cur.t == cur.n - 1;
      const int ha = h0 + r, hb = ha + 8;
      if (whole) {
        const float inv0 = 1.f / fmaxf(ll.x, 1e-30f), inv1 = 1.f / fmaxf(ll.y, 1e-30f);
        bf16* ob = out + (size_t)cur.b * H * kTcL;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 256 * wg + 64 * s + 8 * j + cq;
            if (ha < H)
              *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ha * kTcL + col) =
                  __floats2bfloat162_rn(o[s][4 * j] * inv0, o[s][4 * j + 1] * inv0);
            if (hb < H)
              *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)hb * kTcL + col) =
                  __floats2bfloat162_rn(o[s][4 * j + 2] * inv1, o[s][4 * j + 3] * inv1);
          }
      } else {
        // the partial in the threads' own layout: float4 q = 8 s + j of
        // thread tid, o[s][4 j .. 4 j + 3], at q * 256 + tid (a warp's
        // stores are 512 contiguous bytes); mla_merge_frag_kernel reads it so
        const size_t slot = (size_t)hc * nslot + blk + cur.b;
        if (wg == 0 && lane % 4 == 0) {
          part_ml[slot * kTcHeads + r] = make_float2(m0, ll.x);
          part_ml[slot * kTcHeads + r + 8] = make_float2(m1, ll.y);
        }
        float4* pf = reinterpret_cast<float4*>(part_acc) + slot * (32 * kTcThreads) + tid;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            pf[(8 * s + j) * kTcThreads] =
                make_float4(o[s][4 * j], o[s][4 * j + 1], o[s][4 * j + 2], o[s][4 * j + 3]);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int k = 0; k < 32; ++k) o[s][k] = 0.f;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;
      ++seg;
      __syncthreads();  // the float2s are read
    }
    advance(cur, kv_len, B, S, kTcKeys);
    if (seg_end) seg_t0 = cur.t;
  }
  launch_dependents();
}

cudaError_t launch_wgmma(const void* q_abs, const void* q_rope, const void* ckv,
                         const void* krope, const int* kv_len, void* out, float* ws, int B,
                         int H, int S, int nblocks, float scale, cudaStream_t st) {
  CUtensorMap qm, qrm, cm, rm;
  if (!make_map(&qm, q_abs, kTcL, H, B) || !make_map(&qrm, q_rope, kTcR, H, B) ||
      !make_map(&cm, ckv, kTcL, S, B) || !make_map(&rm, krope, kTcR, S, B))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int chunks = (H + kTcHeads - 1) / kTcHeads;
  const size_t slots = (size_t)chunks * (nblocks + B) * kTcHeads;
  mla_wgmma_kernel<<<dim3(chunks, nblocks), kTcThreads, kTcSmem, st>>>(
      qm, qrm, cm, rm, kv_len, static_cast<bf16*>(out), reinterpret_cast<float2*>(ws),
      ws + 2 * slots, B, H, S, nblocks, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32, and bf16 at other widths: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kHeads = 16;           // query heads a block holds
constexpr int kKeys = 32;            // keys a tile: a warp's lanes
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxL = 2 * kThreads;  // latent width: two output columns a thread

// a probability as the P V product takes it: rounded to bf16 in the bf16 kernel
__device__ __forceinline__ float operand(float p, float) { return p; }
__device__ __forceinline__ float operand(float p, bf16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of a row (4 floats or 8 bf16) as f32
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  // a bf16 is the high half of the f32 with the same value
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
  x[4] = __uint_as_float(t.z << 16); x[5] = __uint_as_float(t.z & 0xffff0000u);
  x[6] = __uint_as_float(t.w << 16); x[7] = __uint_as_float(t.w & 0xffff0000u);
}
// two consecutive elements as f32
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x; b = t.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x; b = t.y;
}

// Shared memory of a block: Q [16][D] f32, the warps' partial scores [8][16]
// [32] f32, P [32][16] f32, (m, l, corr) [16] each, then two tiles of 32
// latent rows [ckv (L) | krope (R)] in T, each row padded by 16 bytes so
// that lanes reading different rows hit different banks.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kHeads * D + kWarps * kHeads * kKeys + kKeys * kHeads +
                          3 * kHeads) +
         sizeof(T) * 2 * kKeys * (size_t)(D + 16 / sizeof(T));
}

// One block: head chunk blockIdx.x (heads [16 x, 16 x + 16) of H), share
// blockIdx.y of the tiles, walked row by row (a segment a row).  q_abs,
// out: (B, H, L); q_rope: (B, H, R); ckv: (B, T, L); krope: (B, T, R);
// part_ml: (chunks, nblocks + B, 16) float2 (m, l); part_acc: (chunks,
// nblocks + B, 16, L).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ krope,
                  const int* __restrict__ kv_len, T* __restrict__ out, float2* part_ml,
                  float* part_acc, int B, int H, int S, int L, int R, int nblocks, float scale) {
  constexpr int CH = 16 / sizeof(T);  // elements of a 16-byte piece
  const int D = L + R, ldk = D + CH, pl = L / CH, pieces = D / CH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kHeads][D]
  float* Sp = Qs + kHeads * D;                 // [kWarps][kHeads][kKeys]
  float* Ps = Sp + kWarps * kHeads * kKeys;    // [kKeys][kHeads]
  float* ms = Ps + kKeys * kHeads;             // running max of each head
  float* ls = ms + kHeads;                     // running sum
  float* cs = ls + kHeads;                     // this tile's correction
  T* Kt = reinterpret_cast<T*>(cs + kHeads);   // [2][kKeys][ldk]

  const int hc = blockIdx.x, blk = blockIdx.y;
  const int total = tiles_before(kv_len, B, S, kKeys, 0).x;
  const int per = (total + nblocks - 1) / nblocks;
  const int g0 = min(total, blk * per), g1 = min(total, g0 + per);
  if (g0 >= g1) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = hc * kHeads, nh = min(kHeads, H - h0);
  const size_t nslot = (size_t)nblocks + B;
  const int c0 = 2 * tid;  // this thread's output columns: c0, c0 + 1 (L is even)

  Cursor cur = seek(kv_len, B, S, kKeys, g0);
  for (int g = g0; g < g1;) {
    // a segment: row b's keys [start, end), tiles [t0, t1) of its n
    const int b = cur.b, t0 = cur.t, t1 = min(cur.n, t0 + g1 - g);
    const int len = min(max(kv_len[b], 0), S);
    const int start = t0 * kKeys, end = min(len, t1 * kKeys);
    const int ntiles = t1 - t0;
    const T* ckv_b = ckv + (size_t)b * S * L;
    const T* kr_b = krope + (size_t)b * S * R;

    auto issue = [&](int t, int stage) {  // tile t of this segment, its valid rows only
      T* dst = Kt + (size_t)stage * kKeys * ldk;
      const int k0 = start + t * kKeys, rows = min(kKeys, end - k0);
      for (int i = tid; i < rows * pieces; i += kThreads) {
        const int j = i / pieces, c = i % pieces;
        const T* src = c < pl ? ckv_b + (size_t)(k0 + j) * L + c * CH
                              : kr_b + (size_t)(k0 + j) * R + (c - pl) * CH;
        cp_async16(dst + j * ldk + c * CH, src);
      }
    };
    issue(0, 0);
    cp_async_commit();

    // Q of the chunk's heads, f32, while the first tile is in flight
    for (int i = tid; i < kHeads * D; i += kThreads) {
      const int hh = i / D, d = i % D;
      float x = 0.f;
      if (hh < nh) {
        const size_t row = (size_t)b * H + h0 + hh;
        x = d < L ? to_f32(q_abs[row * L + d]) : to_f32(q_rope[row * R + d - L]);
      }
      Qs[i] = x;
    }
    if (tid < kHeads) {
      ms[tid] = kNegInf;
      ls[tid] = 0.f;
    }
    float acc[kHeads][2];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) acc[hh][0] = acc[hh][1] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      const int stage = t & 1;
      if (t + 1 < ntiles) {  // the other stage was released at the end of t - 1
        issue(t + 1, stage ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* Kc = Kt + (size_t)stage * kKeys * ldk;
      const int nvalid = min(kKeys, end - (start + t * kKeys));

      // partial scores: lane = key, this warp's pieces of the row
      float sp[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) sp[hh] = 0.f;
      const T* krow = Kc + lane * ldk;
      for (int c = warp; c < pieces; c += kWarps) {
        float x[CH];
        load16(krow + c * CH, x);
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float* qp = Qs + hh * D + c * CH;
#pragma unroll
          for (int e = 0; e < CH; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qp + e);
            sp[hh] = fmaf(qv.x, x[e], sp[hh]);
            sp[hh] = fmaf(qv.y, x[e + 1], sp[hh]);
            sp[hh] = fmaf(qv.z, x[e + 2], sp[hh]);
            sp[hh] = fmaf(qv.w, x[e + 3], sp[hh]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) Sp[(warp * kHeads + hh) * kKeys + lane] = sp[hh];
      __syncthreads();

      // online softmax: a warp per head (heads warp, warp + 8), lane = key;
      // a lane past the tile's valid keys (its row never loaded) is masked
      for (int hh = warp; hh < kHeads; hh += kWarps) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += Sp[(w * kHeads + hh) * kKeys + lane];
        s = lane < nvalid ? s * scale : -INFINITY;
        const float m_old = ms[hh];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = expf(s - m_new);
        const float rs = warp_sum(p);
        Ps[lane * kHeads + hh] = operand(p, T());
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          cs[hh] = corr;
          ls[hh] = ls[hh] * corr + rs;
          ms[hh] = m_new;
        }
      }
      __syncthreads();

      // acc += P V, V the tile's ckv columns
      if (c0 < L) {
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          acc[hh][0] *= cs[hh];
          acc[hh][1] *= cs[hh];
        }
        for (int j = 0; j < nvalid; ++j) {
          float v0, v1;
          load2(Kc + j * ldk + c0, v0, v1);
#pragma unroll
          for (int g4 = 0; g4 < kHeads; g4 += 4) {
            const float4 p = *reinterpret_cast<const float4*>(Ps + j * kHeads + g4);
            acc[g4][0] = fmaf(p.x, v0, acc[g4][0]);
            acc[g4][1] = fmaf(p.x, v1, acc[g4][1]);
            acc[g4 + 1][0] = fmaf(p.y, v0, acc[g4 + 1][0]);
            acc[g4 + 1][1] = fmaf(p.y, v1, acc[g4 + 1][1]);
            acc[g4 + 2][0] = fmaf(p.z, v0, acc[g4 + 2][0]);
            acc[g4 + 2][1] = fmaf(p.z, v1, acc[g4 + 2][1]);
            acc[g4 + 3][0] = fmaf(p.w, v0, acc[g4 + 3][0]);
            acc[g4 + 3][1] = fmaf(p.w, v1, acc[g4 + 3][1]);
          }
        }
      }
      __syncthreads();  // the tile, P and the corrections are read
    }

    const size_t row0 = (size_t)b * H + h0;
    if (t0 == 0 && t1 == cur.n) {  // all of the row: the output
      if (c0 < L) {
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
          if (hh < nh) {
            const float inv = 1.f / fmaxf(ls[hh], 1e-30f);
            store(out + (row0 + hh) * L + c0, acc[hh][0] * inv);
            store(out + (row0 + hh) * L + c0 + 1, acc[hh][1] * inv);
          }
      }
    } else {  // a partial, m in log2 units as the tensor-core kernel's
      const size_t prow = ((size_t)hc * nslot + blk + b) * kHeads;
      if (tid < nh) part_ml[prow + tid] = make_float2(ms[tid] * kLog2e, ls[tid]);
      if (c0 < L) {
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh)
          if (hh < nh)
            *reinterpret_cast<float2*>(part_acc + (prow + hh) * L + c0) =
                make_float2(acc[hh][0], acc[hh][1]);
      }
    }
    __syncthreads();  // Q, (m, l) are read before the next segment's
    g += ntiles;
    cur.t = t1 - 1;
    advance(cur, kv_len, B, S, kKeys);
  }
  launch_dependents();
}

template <typename T>
cudaError_t launch_cuda_cores(const void* q_abs, const void* q_rope, const void* ckv,
                              const void* krope, const int* kv_len, void* out, float* ws,
                              int B, int H, int S, int L, int R, int nblocks, float scale,
                              cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(L + R);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static size_t attr = 48 * 1024;  // the largest dynamic shared memory allowed so far
  if (bytes > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr = bytes;
  }
  const size_t slots = (size_t)((H + kHeads - 1) / kHeads) * (nblocks + B) * kHeads;
  const dim3 grid((H + kHeads - 1) / kHeads, nblocks);
  mla_decode_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), kv_len, static_cast<T*>(out),
      reinterpret_cast<float2*>(ws), ws + 2 * slots, B, H, S, L, R, nblocks, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The merge
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 128;  // four columns a thread: L <= 512
constexpr int kBatch = 8;           // partials whose loads go out together

// The blocks that touched row b, and its tiles (the merge's view of the
// split; every thread of the block gets the same)
struct RowSpan {
  int first, last, n;
};
__device__ RowSpan row_span(const int* kv_len, int b, int B, int S, int keys, int nblocks) {
  const int2 tb = tiles_before(kv_len, B, S, keys, b);
  const int n = row_tiles(kv_len, b, S, keys);
  if (n == 0) return {0, 0, 0};
  const int per = (tb.x + nblocks - 1) / nblocks;
  return {tb.y / per, (tb.y + n - 1) / per, n};
}

// (m, l, acc) of partial k folded into the running one, in block order:
// m is in log2 units; the first fold (m = -1e30) takes the partial as it is
__device__ __forceinline__ void fold(float& m, float& l, float* a, float2 ml, const float* v,
                                     int nv) {
  const float mn = fmaxf(m, ml.x), c = ex2(m - mn), w = ex2(ml.x - mn);
  l = l * c + ml.y * w;
  for (int e = 0; e < nv; ++e) a[e] = fmaf(a[e], c, v[e] * w);
  m = mn;
}

// The CUDA-core kernel's merge.  One block: head blockIdx.x of row
// blockIdx.y; partials row-major (chunk, slot, head, L), thread t holds
// columns [4 t, 4 t + 4).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const int* __restrict__ kv_len, T* __restrict__ out,
                 const float2* __restrict__ part_ml, const float* __restrict__ part_acc, int B,
                 int H, int S, int L, int heads, int keys, int nblocks) {
  const int h = blockIdx.x, b = blockIdx.y, c = 4 * threadIdx.x;
  const RowSpan rs = row_span(kv_len, b, B, S, keys, nblocks);
  T* o = out + ((size_t)b * H + h) * L + c;
  wait_prerequisites();  // every block: the merge ends after the split kernel
  if (c >= L || (rs.n > 0 && rs.first == rs.last)) return;  // one block wrote the row
  float m = kNegInf, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  if (rs.n > 0) {
    const size_t slot0 = (size_t)(h / heads) * (nblocks + B) + b;  // block 0's slot for row b
    const float2* ml = part_ml + slot0 * heads + h % heads;
    const float* pa = part_acc + (slot0 * heads + h % heads) * L + c;
    for (int s0 = rs.first; s0 <= rs.last; s0 += kBatch) {
      float2 mls[kBatch];
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t s = s0 + k;
        const bool ok = s0 + k <= rs.last;
        mls[k] = ok ? ml[s * heads] : make_float2(kNegInf, 0.f);
        v[k] = ok ? *reinterpret_cast<const float4*>(pa + s * heads * L)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k <= rs.last) fold(m, l, a, mls[k], &v[k].x, 4);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);  // a row without keys: 0
#pragma unroll
  for (int e = 0; e < 4; ++e) store(o + e, a[e] * inv);
}

// float4 q of thread tid's partials of row b, head chunk hc, folded
__device__ __forceinline__ void merge_frag(bf16* out, const float2* part_ml,
                                           const float4* part_acc, int B, int H, int nblocks,
                                           const RowSpan& rs, int q, int hc, int b, int tid) {
  const int wg = tid / 128, t = tid % 128, lane = tid % 32;
  const int r = (t / 32) * 16 + lane / 4;
  const int ha = hc * kTcHeads + r, hb = ha + 8;
  const int col = 256 * wg + 64 * (q / 8) + 8 * (q % 8) + 2 * (lane % 4);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, a0[2] = {0.f, 0.f}, a1[2] = {0.f, 0.f};
  if (rs.n > 0) {
    const size_t slot0 = (size_t)hc * (nblocks + B) + b;  // block 0's slot for row b
    const float2* ml = part_ml + slot0 * kTcHeads + r;
    const float4* pf = part_acc + slot0 * (32 * kTcThreads) + q * kTcThreads + tid;
    for (int s0 = rs.first; s0 <= rs.last; s0 += kBatch) {
      float2 ma[kBatch], mb[kBatch];
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t s = s0 + k;
        const bool ok = s0 + k <= rs.last;
        ma[k] = ok ? ml[s * kTcHeads] : make_float2(kNegInf, 0.f);
        mb[k] = ok ? ml[s * kTcHeads + 8] : make_float2(kNegInf, 0.f);
        v[k] = ok ? pf[s * (32 * kTcThreads)] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k <= rs.last) {
          fold(m0, l0, a0, ma[k], &v[k].x, 2);
          fold(m1, l1, a1, mb[k], &v[k].z, 2);
        }
    }
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);  // no keys: 0
  bf16* ob = out + (size_t)b * H * kTcL + col;
  if (ha < H)
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ha * kTcL) =
        __floats2bfloat162_rn(a0[0] * i0, a0[1] * i0);
  if (hb < H)
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)hb * kTcL) =
        __floats2bfloat162_rn(a1[0] * i1, a1[1] * i1);
}

// The tensor-core kernel's merge.  One block: float4s [qper x, qper x +
// qper) of the partials' thread layout (x = blockIdx.x), head chunk
// blockIdx.y, row blockIdx.z; thread t folds its float4 of the row's
// partials in block order, each of its two rows (r, r + 8) by its own
// (m, l).
__global__ void __launch_bounds__(kTcThreads)
mla_merge_frag_kernel(const int* __restrict__ kv_len, bf16* __restrict__ out,
                      const float2* __restrict__ part_ml, const float4* __restrict__ part_acc,
                      int B, int H, int S, int nblocks, int qper) {
  const int hc = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const RowSpan rs = row_span(kv_len, b, B, S, kTcKeys, nblocks);
  wait_prerequisites();  // every block: the merge ends after the split kernel
  if (rs.n > 0 && rs.first == rs.last) return;  // one block wrote the row
  for (int q = blockIdx.x * qper; q < (blockIdx.x + 1) * qper; ++q)
    merge_frag(out, part_ml, part_acc, B, H, nblocks, rs, q, hc, b, tid);
}

// a launch that may begin before the previous kernel on the stream ends
// (programmatic dependent launch; see wait_prerequisites)
template <typename... Params, typename... Args>
cudaError_t launch_after(dim3 grid, int threads, cudaStream_t st, void (*kernel)(Params...),
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T>
cudaError_t launch_merge(const int* kv_len, void* out, float* ws, int B, int H, int S, int L,
                         int heads, int keys, int nblocks, cudaStream_t st) {
  const size_t slots = (size_t)((H + heads - 1) / heads) * (nblocks + B) * heads;
  return launch_after(dim3(H, B), kMergeThreads, st, mla_merge_kernel<T>, kv_len,
                      static_cast<T*>(out), reinterpret_cast<const float2*>(ws),
                      ws + 2 * slots, B, H, S, L, heads, keys, nblocks);
}

}  // namespace

// q_abs, out: (B, H, L); q_rope: (B, H, R); ckv: (B, S, L); krope: (B, S, R);
// kv_len: (B,) int32; all contiguous on the device, 16-byte aligned; L and R
// multiples of 8, L <= 512.  ws: an f32 workspace of slots * (L + 2) floats,
// slots = ceil(H / heads) * (nblocks + B) * heads, with (heads, keys) = (64,
// 64) for bf16 at L 512, R 64 (tensor cores) and (16, 32) otherwise (CUDA
// cores; ops.ROUTES).  dtype 0 = float32, 1 = bfloat16.  Two launches, the
// split kernel and the merge; returns the first cudaError_t (0 when both
// were accepted).
extern "C" int mla_decode(const void* q_abs, const void* q_rope, const void* ckv,
                          const void* krope, const void* kv_len, void* out, void* ws, int B,
                          int H, int S, int L, int R, int nblocks, float scale, int dtype,
                          void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || L <= 0 || L > kMaxL || L % 8 != 0 ||
      R <= 0 || R % 8 != 0 || nblocks <= 0 || nblocks > 65535 || ws == nullptr ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(kv_len);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && L == kTcL && R == kTcR) {
    err = launch_wgmma(q_abs, q_rope, ckv, krope, lens, out, w, B, H, S, nblocks, scale, st);
    if (err == cudaSuccess) {
      const int chunks = (H + kTcHeads - 1) / kTcHeads;
      const size_t slots = (size_t)chunks * (nblocks + B) * kTcHeads;
      // a float4 of the layout a block where chunks * B blocks are few,
      // more where they are many (the blocks of a row that one block held
      // whole have nothing to do but read kv_len)
      int qper = 1;
      while (qper < 32 && chunks * B * 32 / qper > 1024) qper *= 2;
      err = launch_after(dim3(32 / qper, chunks, B), kTcThreads, st, mla_merge_frag_kernel,
                         lens, static_cast<bf16*>(out), reinterpret_cast<const float2*>(w),
                         reinterpret_cast<const float4*>(w + 2 * slots), B, H, S, nblocks,
                         qper);
    }
  } else if (dtype == 1) {
    err = launch_cuda_cores<bf16>(q_abs, q_rope, ckv, krope, lens, out, w, B, H, S, L, R,
                                  nblocks, scale, st);
    if (err == cudaSuccess)
      err = launch_merge<bf16>(lens, out, w, B, H, S, L, kHeads, kKeys, nblocks, st);
  } else {
    err = launch_cuda_cores<float>(q_abs, q_rope, ckv, krope, lens, out, w, B, H, S, L, R,
                                   nblocks, scale, st);
    if (err == cudaSuccess)
      err = launch_merge<float>(lens, out, w, B, H, S, L, kHeads, kKeys, nblocks, st);
  }
  return err;
}

extern "C" const char* mla_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
