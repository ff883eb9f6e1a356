// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of softmax
// attention, causal or not, with a query offset and grouped KV heads.
//
// A new kernel, not a port: the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel) is forward-only
// and the JAX model differentiates its XLA attention.  It is the gradient of
// flash_attention.cu's function: query i of a head sits at position
// q_offset + i, keys k < Sk are valid, a causal query sees keys k <= its
// position, query head h reads KV head h / group.  The forward keeps each
// row's log-sum-exp (lse, natural log, +inf for a row with no visible key),
// so the probabilities are recomputed here, never stored (the FA2 form):
//
//   P  = exp(S - lse),  S = Q K^T / sqrt(hd), masked
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D)
//   dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd)
//
// What bounds it on this card.  Five products of the forward's size (S and
// dP recomputed, dV, dQ, dK): about 10 * B * Hq * pairs * hd FLOPs, where
// pairs counts the visible (query, key) pairs, on 8 tensors of q's or k's
// size read or written.  At the training shape (B 4, Hq 16, S 512, hd 64,
// causal) that is 5.4 GFLOP on 34 MB (bf16) or 67 MB (f32): in bf16 on
// wgmma the bytes bind (10 µs against 5.4 µs of products at 989 TFLOP/s);
// in f32, as three TF32 products (495 / 3 TFLOP/s), the operations (33 µs
// against 20 µs of bytes).
//
// Three launches a call, deterministic (no atomics, a fixed order of sums):
//
//  * D: rowdot_kernel, 16 bytes of O and of dO a thread, as many rows a
//    warp as fit (dot_kernel, one warp a row, for rows of another width);
//  * dK/dV: one block per (b, KV head, 64 keys).  K and V stay in shared
//    memory; the block walks the query tiles of every query head of its
//    group that can see its keys (from the first query whose position
//    reaches the block's first key), keeping dK and dV in registers.  The
//    grid is (B * Hkv, key blocks) with the key block on the slow axis, so
//    the blocks of the first keys, which walk the most causal tiles, start
//    first and the short ones fill in behind them;
//  * dQ: one block per (b, h, 64 queries) over the key tiles the forward
//    visits, tiles from the last (the longest first).  S and dP are
//    computed a second time there instead of adding dQ across key blocks
//    with atomics.
//
// Where a grid has fewer blocks than the card has SMs (few KV heads under
// GQA; few queries over many keys), the tensor-core routes split each
// block's walk over gridDim.z blocks; the last of a tile's blocks to finish
// adds their f32 partial sums in split order (combine_splits), so the
// result does not depend on the order blocks run in either.
//
// Three routes for the two products kernels, chosen by the caller (bwd.py):
//
//  * bf16, hd a multiple of 8 (the TMA rows): wgmma.  One warpgroup a
//    block.  Tiles of 64 rows by 64 columns arrive by TMA, 128-byte swizzle
//    (the forward's maps), the walked tiles through a ring of two stages
//    with mbarriers.  The dK/dV block computes the scores transposed, S^T =
//    K Q^T and dP^T = V dO^T (wgmma SS), so that P^T and dS^T land in the
//    accumulator layout; rounded to bf16 in registers they are the A operand
//    of dV += P^T dO and dK += dS^T Q (wgmma RS, B MN-major through the
//    descriptor), as the forward feeds P to P V.  The dQ block does the
//    same with S = Q K^T, dP = dO V^T and dQ += dS K.
//  * f32, hd a multiple of 4 up to 64: the tensor cores in 3xTF32.  Each
//    operand x is split into hi = tf32(x) and lo = tf32(x - hi)
//    (cvt.rna), and each product is lo*hi + hi*lo + hi*hi in mma.sync
//    m16n8k8 with f32 accumulation: about 2^-21 relative per product, where
//    one TF32 product keeps 2^-11.  mma.sync and not wgmma: wgmma takes
//    TF32 only K-major, and P^T dO and dS^T Q are not.  Four warps a block,
//    16 rows each; f32 tiles arrive by cp.async (two stages) into an
//    XOR-swizzled layout that every fragment load reads without bank
//    conflicts.  The k index of each 8-wide step is permuted (slot t holds
//    2t, slot t + 4 holds 2t + 1) in both operands, so that a warp's P and
//    dS accumulators are already the A fragments of the next product and
//    A / K-major B fragments load 8 bytes at a time.  At hd 128 (HD = 128)
//    a thread's dK and dV took 128 registers, spilled, and one block filled
//    an SM's shared memory: it ran slower than the CUDA cores (PERF.md), so
//    f32 above hd 64 takes those and only HD = 64 is launched;
//  * the other dtype and hd: the CUDA cores, f32 accumulation: tiles as f32
//    rows of hd + 4 in shared memory, each of 256 threads a 4 x 4 tile of S
//    and dP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;            // queries or keys per tile
constexpr int kSlice = kTile * 64;   // elements of one 64 x 64 bf16 slice (8 KB)
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float pick(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O)
// ---------------------------------------------------------------------------

// 2^lanes_log2 threads a row, each reading 16 bytes of O and of dO (hd
// elements a multiple of 16 bytes; a row has at most 32 such pieces).
template <typename T>
__global__ void __launch_bounds__(256)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
              int rows, int hd, int lanes_log2) {
  constexpr int E = 16 / (int)sizeof(T);
  const long long gid = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = gid >> lanes_log2;
  const int j = (int)(gid & ((1 << lanes_log2) - 1));
  float acc = 0.f;
  if (row < rows && j * E < hd) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * hd + j * E);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * hd + j * E);
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(&a);
      const float4 y = *reinterpret_cast<const float4*>(&b);
      acc = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    } else {
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(x[e]), w = __bfloat1622float2(y[e]);
        acc += u.x * w.x + u.y * w.y;
      }
    }
  }
  for (int off = (1 << lanes_log2) / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && j == 0) delta[row] = acc;
}

// One warp a row, element by element (rows that 16-byte loads cannot take).
template <typename T>
__global__ void __launch_bounds__(256)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
           int rows, int hd) {
  const int row = (blockIdx.x * 256 + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + (size_t)row * hd;
  const T* b = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(a[d]) * to_f32(b[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
cudaError_t launch_dot(const void* o, const void* dout, float* delta, int rows, int hd,
                       cudaStream_t st) {
  constexpr int E = 16 / (int)sizeof(T);
  if (hd % E == 0) {
    int lg = 0;
    while ((1 << lg) * E < hd) ++lg;
    const long long threads = (long long)rows << lg;
    rowdot_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, hd, lg);
  } else {
    dot_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(static_cast<const T*>(o),
                                                  static_cast<const T*>(dout), delta, rows, hd);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A tile's walk split over gridDim.z blocks
// ---------------------------------------------------------------------------

// Where a tile's walk is split, each of the tile's blocks (128 threads)
// leaves its F f32 partial sums a thread (element f of thread t at
// [f * 128 + t]) in its slot of the tile's scratch; the last block of the
// tile to arrive (one int counter a tile, which it leaves at 0) adds the
// slots in split order, so the result does not depend on which block
// finished last.  `at(f)` is this thread's element f (a constant index once
// unrolled, so the accumulators stay in registers); the sums go 16 elements
// at a time, which bounds the loads in flight.  Returns whether this block
// holds the sum.
template <int F, typename At>
__device__ __forceinline__ bool combine_splits(At&& at, float* part, int* counter) {
  constexpr int n = 128, kChunk = 16;
  static_assert(F % kChunk == 0, "whole chunks");
  const int tid = threadIdx.x;
  float* slot = part + (size_t)blockIdx.z * F * n;
#pragma unroll
  for (int f = 0; f < F; ++f) slot[f * n + tid] = at(f);
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int c = 0; c < F; c += kChunk) {
#pragma unroll
    for (int f = c; f < c + kChunk; ++f) at(f) = 0.f;
#pragma unroll 1
    for (int z = 0; z < (int)gridDim.z; ++z) {
      const float* p = part + (size_t)z * F * n + tid;
#pragma unroll
      for (int f = c; f < c + kChunk; ++f) at(f) += __ldcg(p + f * n);
    }
  }
  if (tid == 0) *counter = 0;
  return true;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

template <int HD>
constexpr int wg_smem_bytes() {
  // six (64, HD) bf16 tiles (dK/dV: K, V and two stages of Q, dO; dQ: Q, dO
  // and two stages of K, V), lse and D of two stages, three mbarriers, and
  // slack for 1024-byte alignment
  return (HD / 64) * kSlice * 2 * 6 + 4 * kTile * 4 + 8 * 3 + 1024;
}

__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~static_cast<uintptr_t>(1023));
}

// One block, one warpgroup: keys [k0, k0 + 64) of KV head (b, hk) =
// blockIdx.x, k0 = 64 blockIdx.y.  Maps: q, dout (hd, Sq, B * Hq); k, v
// (hd, Sk, B * Hkv); boxes (64, 64, 1).  Work item i is query tile
// first + i % per_head of the group's query head i / per_head.
template <int HD>
__global__ void __launch_bounds__(128)
wg_dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
               int* __restrict__ counters, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
               int q_offset, float scale, float scale_log2) {
  constexpr int NS = HD / 64;                       // 64-column slices of hd
  constexpr uint32_t kTileBytes = NS * kSlice * 2;  // one tile
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + NS * kSlice;
  bf16* QO = Vs + NS * kSlice;                      // stage s: Q at 2s NS, dO after it
  float* Ls = reinterpret_cast<float*>(QO + 4 * NS * kSlice);  // [2][64], log2 units
  float* Dl = Ls + 2 * kTile;                                  // [2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Dl + 2 * kTile);  // k/v, full[2]

  const int kvbh = blockIdx.x, b = kvbh / Hkv, hk = kvbh % Hkv, group = Hq / Hkv;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // queries before k0 - q_offset see none of these keys
  const int first = causal ? max(0, k0 - q_offset) / kTile : 0;
  const int per_head = max(0, (Sq + kTile - 1) / kTile - first);
  const int n = group * per_head;
  // this block's share of the walk: items [i0, i1)
  const int i0 = (int)((long long)n * blockIdx.z / gridDim.z);
  const int i1 = (int)((long long)n * (blockIdx.z + 1) / gridDim.z);
  auto bh_of = [&](int i) { return b * Hq + hk * group + i / per_head; };
  auto q0_of = [&](int i) { return (first + i % per_head) * kTile; };

  auto issue = [&](int i, int stage) {
    bf16* Qs = QO + stage * 2 * NS * kSlice;
    bf16* dOs = Qs + NS * kSlice;
    mbar_expect_tx(&bars[1 + stage], 2 * kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(Qs + s * kSlice, &qmap, &bars[1 + stage], s * 64, q0_of(i), bh_of(i));
      tma_load_3d(dOs + s * kSlice, &domap, &bars[1 + stage], s * 64, q0_of(i), bh_of(i));
    }
  };
  // threads 0-63: the lse (log2 units) of item i's row tid; 64-127: its D
  auto row_stat = [&](int i) {
    const int r = q0_of(i) + tid % 64;
    const size_t at = (size_t)bh_of(i) * Sq + r;
    if (tid < 64) return r < Sq ? lse[at] * kLog2e : INFINITY;
    return r < Sq ? delta[at] : 0.f;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(Ks + s * kSlice, &kmap, &bars[0], s * 64, k0, kvbh);
      tma_load_3d(Vs + s * kSlice, &vmap, &bars[0], s * 64, k0, kvbh);
    }
    if (i0 < i1) issue(i0, 0);
  }
  if (i0 < i1) (tid < 64 ? Ls : Dl)[tid % 64] = row_stat(i0);
  __syncthreads();

  // this thread's key rows of the 64: r and r + 8; its query columns of
  // each 8-column block j: 8j + cq + {0, 1}
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float dka[NS][32], dva[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[s][e] = dva[s][e] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int i = i0; i < i1; ++i) {
    const int stage = (i - i0) & 1;
    // the other stage was last read in item i - 1, which every thread has
    // finished (the __syncthreads at the end of the loop)
    if (tid == 0 && i + 1 < i1) issue(i + 1, stage ^ 1);
    const float next = i + 1 < i1 ? row_stat(i + 1) : 0.f;
    mbar_wait(&bars[1 + stage], ((i - i0) >> 1) & 1);
    const bf16* Qs = QO + stage * 2 * NS * kSlice;
    const bf16* dOs = Qs + NS * kSlice;
    const float* L = Ls + stage * kTile;
    const float* Dr = Dl + stage * kTile;

    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * kSlice + (kk % 4) * 16;  // 32 bytes a k step, then the next slice
      wgmma_ss(st, desc_sw128(Ks + off, 16, 1024), desc_sw128(Qs + off, 16, 1024), kk > 0);
      wgmma_ss(dpt, desc_sw128(Vs + off, 16, 1024), desc_sw128(dOs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in place; masks only on a tile that crosses the
    // diagonal (keys past Sk give rows of dK, dV that are not stored;
    // queries past Sq have lse = +inf, so P = 0 there)
    const int q0 = q0_of(i);
    const bool edge = causal && k0 + kTile - 1 > q_offset + q0;
    uint32_t pa[4][4], sa[4][4];  // P^T and dS^T as A operands, one 16-query step each
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(Dr + 8 * j + cq);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lc = c ? l2.y : l2.x, dc = c ? d2.y : d2.x;
        const int qpos = q_offset + q0 + 8 * j + cq + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + c;
          float p = ex2(fmaf(st[e], scale_log2, -lc));
          if (edge && qpos < k0 + r + 8 * h) p = 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dc);
        }
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      sa[j / 2][(j % 2) * 2] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
    }

    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries = 16 rows of 128 bytes
        wgmma_rs(dva[s], pa[kk], desc_sw128(dOs + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
        wgmma_rs(dka[s], sa[kk], desc_sw128(Qs + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      fence_regs(dva[s]);
      fence_regs(dka[s]);
    }
    // the other stage's lse and D were last read in item i - 1
    if (i + 1 < i1) (tid < 64 ? Ls : Dl)[(stage ^ 1) * kTile + tid % 64] = next;
    __syncthreads();
  }
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (gridDim.z > 1 &&
      !combine_splits<2 * NS * 32>(
          [&](int f) -> float& {
            return f < NS * 32 ? dka[f / 32][f % 32] : dva[f / 32 - NS][f % 32];
          },
          part + (size_t)tile * gridDim.z * 2 * kTile * HD, counters + tile))
    return;

  const size_t base = (size_t)kvbh * Sk * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r + 8 * h;
    if (key >= Sk) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * 64 + 8 * j + cq, e = 4 * j + 2 * h;
        if (col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)key * hd + col) =
              __floats2bfloat162_rn(dka[s][e] * scale, dka[s][e + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + base + (size_t)key * hd + col) =
              __floats2bfloat162_rn(dva[s][e], dva[s][e + 1]);
        }
      }
  }
}

// One block, one warpgroup: queries [q0, q0 + 64) of (b, h) = blockIdx.x,
// tiles from the last (q0 = 64 (gridDim.y - 1 - blockIdx.y)).
template <int HD>
__global__ void __launch_bounds__(128)
wg_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
             const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, float* __restrict__ part, int* __restrict__ counters,
             int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
             float scale_log2) {
  constexpr int NS = HD / 64;
  constexpr uint32_t kTileBytes = NS * kSlice * 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = align1024(smem_raw);
  bf16* dOs = Qs + NS * kSlice;
  bf16* KV = dOs + NS * kSlice;                     // stage s: K at 2s NS, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(KV + 4 * NS * kSlice);  // q/do, full[2]

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys past k_end are invisible to every query of this block
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kTile, Sq)) : Sk;
  const int n = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;
  // this block's share of the walk: key tiles [t0, t1)
  const int t0 = (int)((long long)n * blockIdx.z / gridDim.z);
  const int t1 = (int)((long long)n * (blockIdx.z + 1) / gridDim.z);

  auto issue_kv = [&](int t, int stage) {
    bf16* Ks = KV + stage * 2 * NS * kSlice;
    bf16* Vs = Ks + NS * kSlice;
    mbar_expect_tx(&bars[1 + stage], 2 * kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(Ks + s * kSlice, &kmap, &bars[1 + stage], s * 64, t * kTile, kvbh);
      tma_load_3d(Vs + s * kSlice, &vmap, &bars[1 + stage], s * 64, t * kTile, kvbh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(Qs + s * kSlice, &qmap, &bars[0], s * 64, q0, bh);
      tma_load_3d(dOs + s * kSlice, &domap, &bars[0], s * 64, q0, bh);
    }
    if (t0 < t1) issue_kv(t0, 0);
  }

  // this thread's query rows of the 64: r and r + 8; its key columns of
  // each 8-column block j: 8j + cq + {0, 1}
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int row0 = q0 + r, row1 = row0 + 8;
  const int qpos0 = q_offset + row0, qpos1 = qpos0 + 8;
  const float l0 = row0 < Sq ? lse[(size_t)bh * Sq + row0] * kLog2e : INFINITY;
  const float l1 = row1 < Sq ? lse[(size_t)bh * Sq + row1] * kLog2e : INFINITY;
  const float d0 = row0 < Sq ? delta[(size_t)bh * Sq + row0] : 0.f;
  const float d1 = row1 < Sq ? delta[(size_t)bh * Sq + row1] : 0.f;
  float dqa[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) dqa[s][e] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (tid == 0 && t + 1 < t1) issue_kv(t + 1, stage ^ 1);
    mbar_wait(&bars[1 + stage], ((t - t0) >> 1) & 1);
    const bf16* Ks = KV + stage * 2 * NS * kSlice;
    const bf16* Vs = Ks + NS * kSlice;

    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * kSlice + (kk % 4) * 16;
      wgmma_ss(sc, desc_sw128(Qs + off, 16, 1024), desc_sw128(Ks + off, 16, 1024), kk > 0);
      wgmma_ss(dp, desc_sw128(dOs + off, 16, 1024), desc_sw128(Vs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * kTile;
    const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q_offset + q0);
    uint32_t sa[4][4];  // dS as the A operand, one 16-key step each
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kc = k0 + 8 * j + cq + c;
        float p0 = ex2(fmaf(sc[4 * j + c], scale_log2, -l0));
        float p1 = ex2(fmaf(sc[4 * j + 2 + c], scale_log2, -l1));
        if (edge && (kc >= Sk || (causal && qpos0 < kc))) p0 = 0.f;
        if (edge && (kc >= Sk || (causal && qpos1 < kc))) p1 = 0.f;
        dp[4 * j + c] = p0 * (dp[4 * j + c] - d0);
        dp[4 * j + 2 + c] = p1 * (dp[4 * j + 2 + c] - d1);
      }
      sa[j / 2][(j % 2) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
    }

    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(dqa[s], sa[kk], desc_sw128(Ks + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) fence_regs(dqa[s]);
    __syncthreads();  // both stages' readers are done before the next issue
  }
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (gridDim.z > 1 &&
      !combine_splits<NS * 32>([&](int f) -> float& { return dqa[f / 32][f % 32]; },
                               part + (size_t)tile * gridDim.z * kTile * HD, counters + tile))
    return;

  bf16* out = dq + (size_t)bh * Sq * hd;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = s * 64 + 8 * j + cq;
      if (col < hd) {
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row0 * hd + col) =
              __floats2bfloat162_rn(dqa[s][4 * j] * scale, dqa[s][4 * j + 1] * scale);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row1 * hd + col) =
              __floats2bfloat162_rn(dqa[s][4 * j + 2] * scale, dqa[s][4 * j + 3] * scale);
      }
    }
}

// The blocks a kernel's tile walk is split over, with their scratch (f32
// partial sums) and counters (one a tile, zero); both unused when n is 1.
struct WalkSplit {
  int n;
  float* part;
  int* counters;
};

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, void* dk, void* dv,
                         int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int q_offset,
                         cudaStream_t st, const WalkSplit& kv, const WalkSplit& qs) {
  CUtensorMap qm, dom, km, vm;
  if (!make_map(&qm, q, hd, Sq, B * Hq) || !make_map(&dom, dout, hd, Sq, B * Hq) ||
      !make_map(&km, k, hd, Sk, B * Hkv) || !make_map(&vm, v, hd, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  constexpr int bytes = wg_smem_bytes<HD>();
  // the opt-in above 48 KB belongs to the current device: set it every call
  cudaError_t err = cudaFuncSetAttribute(wg_dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wg_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd), scale_log2 = scale * kLog2e;
  wg_dkdv_kernel<HD><<<dim3(B * Hkv, (Sk + kTile - 1) / kTile, kv.n), 128, bytes, st>>>(
      qm, dom, km, vm, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), kv.part,
      kv.counters, Hq, Hkv, Sq, Sk, hd, causal, q_offset, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wg_dq_kernel<HD><<<dim3(B * Hq, (Sq + kTile - 1) / kTile, qs.n), 128, bytes, st>>>(
      qm, dom, km, vm, lse, delta, static_cast<bf16*>(dq), qs.part, qs.counters, Hq, Hkv, Sq,
      Sk, hd, causal, q_offset, scale, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // four warps, 16 rows each

// Element (r, c) of a (64, HD) f32 tile in shared memory.  The XOR moves
// 8-column groups by row so that the three fragment loads below hit 32
// distinct banks: rows g (and g + 8) at columns 2t, 2t + 1 as 8-byte pairs,
// and rows 2t (or 2t + 1) at column g; groups of 4 columns stay whole, so
// 16-byte copies land intact.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HD + (c ^ ((((r & 3) ^ ((r >> 2) & 1))) << 3));
}

// Rows [r0, r0 + 64) of a (rows, hd) f32 matrix (hd % 4 == 0) into a
// swizzled (64, HD) tile by cp.async; rows >= nrows and columns >= hd are zero.
template <int HD>
__device__ __forceinline__ void load_swz(float* dst, const float* src, int r0, int nrows,
                                         int hd) {
  for (int i = threadIdx.x; i < kTile * HD / 4; i += kTcThreads) {
    const int rr = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float* d = dst + swz<HD>(rr, c);
    if (r0 + rr < nrows && c < hd)
      cp_async16(d, src + (size_t)(r0 + rr) * hd + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (round to nearest, ties away from zero)
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c (16 x 8) += a (16 x 8) b (8 x 8) in 3xTF32: the two cross terms, then
// hi * hi.  Fragments: a[0..3] = (row g, slot t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b[0..1] = (slot t, column g), (t + 4, g); c as mma.sync's.
__device__ __forceinline__ void mma3(float* c, const Split (&a)[4], const Split (&b)[2]) {
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// A fragment of k step ks from rows m0.. of a row-major tile (slot t = column
// 8 ks + 2t, slot t + 4 = 8 ks + 2t + 1)
template <int HD>
__device__ __forceinline__ void frag_a(Split (&a)[4], const float* s, int m0, int ks, int g,
                                       int t) {
  const float2 x = *reinterpret_cast<const float2*>(s + swz<HD>(m0 + g, 8 * ks + 2 * t));
  const float2 y = *reinterpret_cast<const float2*>(s + swz<HD>(m0 + g + 8, 8 * ks + 2 * t));
  a[0] = split(x.x);
  a[1] = split(y.x);
  a[2] = split(x.y);
  a[3] = split(y.y);
}
// B fragment (k step ks, columns 8 nt..) of a tile stored [n][k] (K-major)
template <int HD>
__device__ __forceinline__ void frag_bk(Split (&b)[2], const float* s, int nt, int ks, int g,
                                        int t) {
  const float2 x = *reinterpret_cast<const float2*>(s + swz<HD>(8 * nt + g, 8 * ks + 2 * t));
  b[0] = split(x.x);
  b[1] = split(x.y);
}
// B fragment (k step ks, columns 8 nt..) of a tile stored [k][n] (MN-major)
template <int HD>
__device__ __forceinline__ void frag_bn(Split (&b)[2], const float* s, int ks, int nt, int g,
                                        int t) {
  b[0] = split(s[swz<HD>(8 * ks + 2 * t, 8 * nt + g)]);
  b[1] = split(s[swz<HD>(8 * ks + 2 * t + 1, 8 * nt + g)]);
}
// An accumulator tile (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3) as
// the A fragment of the next product's k step, in the permuted slots
__device__ __forceinline__ void frag_acc(Split (&a)[4], const float* c) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

template <int HD>
constexpr int tc_smem_bytes() {
  // six (64, HD) f32 tiles (as the wgmma kernels), lse and D of two stages
  return (int)sizeof(float) * (6 * kTile * HD + 4 * kTile);
}

// One block: keys [k0, k0 + 64) of KV head (b, hk) = blockIdx.x, k0 =
// 64 blockIdx.y; warp w owns keys 16w..16w + 15, its S^T and dP^T over the
// tile's 64 queries, and its rows of dK and dV.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
tf32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                 int* __restrict__ counters, int Hq, int Hkv, int Sq, int Sk, int hd,
                 int causal, int q_offset, float scale, float scale_log2) {
  constexpr int NT = HD / 8;   // 8-column tiles (and k steps) of hd
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;
  float* Vs = Ks + kTile * HD;
  float* QO = Vs + kTile * HD;        // stage s: Q at 2s, dO at 2s + 1
  float* Ls = QO + 4 * kTile * HD;    // [2][64], log2 units
  float* Dl = Ls + 2 * kTile;         // [2][64]

  const int kvbh = blockIdx.x, b = kvbh / Hkv, hk = kvbh % Hkv, group = Hq / Hkv;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int first = causal ? max(0, k0 - q_offset) / kTile : 0;
  const int per_head = max(0, (Sq + kTile - 1) / kTile - first);
  const int n = group * per_head;
  const int i0 = (int)((long long)n * blockIdx.z / gridDim.z);
  const int i1 = (int)((long long)n * (blockIdx.z + 1) / gridDim.z);
  auto bh_of = [&](int i) { return b * Hq + hk * group + i / per_head; };
  auto q0_of = [&](int i) { return (first + i % per_head) * kTile; };
  auto load_item = [&](int i, int stage) {
    float* Qs = QO + stage * 2 * kTile * HD;
    load_swz<HD>(Qs, q + (size_t)bh_of(i) * Sq * hd, q0_of(i), Sq, hd);
    load_swz<HD>(Qs + kTile * HD, dout + (size_t)bh_of(i) * Sq * hd, q0_of(i), Sq, hd);
  };
  auto row_stat = [&](int i) {
    const int r = q0_of(i) + tid % 64;
    const size_t at = (size_t)bh_of(i) * Sq + r;
    if (tid < 64) return r < Sq ? lse[at] * kLog2e : INFINITY;
    return r < Sq ? delta[at] : 0.f;
  };

  load_swz<HD>(Ks, k + (size_t)kvbh * Sk * hd, k0, Sk, hd);
  load_swz<HD>(Vs, v + (size_t)kvbh * Sk * hd, k0, Sk, hd);
  if (i0 < i1) {
    load_item(i0, 0);
    (tid < 64 ? Ls : Dl)[tid % 64] = row_stat(i0);
  }
  cp_async_commit();

  const int m0 = 16 * warp;
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int i = i0; i < i1; ++i) {
    const int stage = (i - i0) & 1;
    if (i + 1 < i1) {  // the other stage was released at the end of item i - 1
      load_item(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float next = i + 1 < i1 ? row_stat(i + 1) : 0.f;
    __syncthreads();
    const float* Qs = QO + stage * 2 * kTile * HD;
    const float* dOs = Qs + kTile * HD;
    const float* L = Ls + stage * kTile;
    const float* Dr = Dl + stage * kTile;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by 64 queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < NT; ++ks) {
      Split ak[4], av[4];
      frag_a<HD>(ak, Ks, m0, ks, g, t);
      frag_a<HD>(av, Vs, m0, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Split bq[2], bo[2];
        frag_bk<HD>(bq, Qs, nt, ks, g, t);
        frag_bk<HD>(bo, dOs, nt, ks, g, t);
        mma3(st[nt], ak, bq);
        mma3(dpt[nt], av, bo);
      }
    }

    // P^T and dS^T in place (masks as in the wgmma kernel)
    const int q0 = q0_of(i);
    const bool edge = causal && k0 + kTile - 1 > q_offset + q0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(L + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Dr + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? l2.y : l2.x, dc = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(st[nt][e], scale_log2, -lc));
        if (edge && q_offset + q0 + col + (e & 1) < k0 + m0 + g + 8 * (e >> 1)) p = 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dc);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      Split ap[4], as[4];
      frag_acc(ap, st[ks]);
      frag_acc(as, dpt[ks]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Split bo[2], bq[2];
        frag_bn<HD>(bo, dOs, ks, nt, g, t);
        frag_bn<HD>(bq, Qs, ks, nt, g, t);
        mma3(dva[nt], ap, bo);
        mma3(dka[nt], as, bq);
      }
    }
    if (i + 1 < i1) (tid < 64 ? Ls : Dl)[(stage ^ 1) * kTile + tid % 64] = next;
    __syncthreads();  // this stage's tiles, lse and D are read
  }
  cp_async_wait<0>();  // K and V, when no query sees these keys
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (gridDim.z > 1 &&
      !combine_splits<2 * NT * 4>(
          [&](int f) -> float& {
            return f < NT * 4 ? dka[f / 4][f % 4] : dva[f / 4 - NT][f % 4];
          },
          part + (size_t)tile * gridDim.z * 2 * kTile * HD, counters + tile))
    return;

  const size_t base = (size_t)kvbh * Sk * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + g + 8 * h;
    if (key >= Sk) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < hd) {
        *reinterpret_cast<float2*>(dk + base + (size_t)key * hd + col) =
            make_float2(dka[nt][2 * h] * scale, dka[nt][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dv + base + (size_t)key * hd + col) =
            make_float2(dva[nt][2 * h], dva[nt][2 * h + 1]);
      }
    }
  }
}

// One block: queries [q0, q0 + 64) of (b, h) = blockIdx.x, tiles from the
// last; warp w owns queries 16w..16w + 15 and their rows of dQ.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
tf32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, float* __restrict__ part, int* __restrict__ counters,
               int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
               float scale_log2) {
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* dOs = Qs + kTile * HD;
  float* KV = dOs + kTile * HD;        // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float* kb = k + (size_t)kvbh * Sk * hd;
  const float* vb = v + (size_t)kvbh * Sk * hd;
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kTile, Sq)) : Sk;
  const int n = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;
  const int t0 = (int)((long long)n * blockIdx.z / gridDim.z);
  const int t1 = (int)((long long)n * (blockIdx.z + 1) / gridDim.z);

  load_swz<HD>(Qs, q + (size_t)bh * Sq * hd, q0, Sq, hd);
  load_swz<HD>(dOs, dout + (size_t)bh * Sq * hd, q0, Sq, hd);
  if (t0 < t1) {
    load_swz<HD>(KV, kb, t0 * kTile, Sk, hd);
    load_swz<HD>(KV + kTile * HD, vb, t0 * kTile, Sk, hd);
  }
  cp_async_commit();

  const int m0 = 16 * warp, row0 = q0 + m0 + g, row1 = row0 + 8;
  const float l0 = row0 < Sq ? lse[(size_t)bh * Sq + row0] * kLog2e : INFINITY;
  const float l1 = row1 < Sq ? lse[(size_t)bh * Sq + row1] * kLog2e : INFINITY;
  const float d0 = row0 < Sq ? delta[(size_t)bh * Sq + row0] : 0.f;
  const float d1 = row1 < Sq ? delta[(size_t)bh * Sq + row1] : 0.f;
  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int it = t0; it < t1; ++it) {
    const int stage = (it - t0) & 1, k0 = it * kTile;
    if (it + 1 < t1) {
      float* Kn = KV + (stage ^ 1) * 2 * kTile * HD;
      load_swz<HD>(Kn, kb, k0 + kTile, Sk, hd);
      load_swz<HD>(Kn + kTile * HD, vb, k0 + kTile, Sk, hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = KV + stage * 2 * kTile * HD;
    const float* Vs = Ks + kTile * HD;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries by 64 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < NT; ++ks) {
      Split aq[4], ao[4];
      frag_a<HD>(aq, Qs, m0, ks, g, t);
      frag_a<HD>(ao, dOs, m0, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Split bk[2], bv[2];
        frag_bk<HD>(bk, Ks, nt, ks, g, t);
        frag_bk<HD>(bv, Vs, nt, ks, g, t);
        mma3(sc[nt], aq, bk);
        mma3(dp[nt], ao, bv);
      }
    }

    const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + 8 * nt + 2 * t + (e & 1);
        const int qpos = q_offset + (e < 2 ? row0 : row1);
        float p = ex2(fmaf(sc[nt][e], scale_log2, -(e < 2 ? l0 : l1)));
        if (edge && (kc >= Sk || (causal && qpos < kc))) p = 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? d0 : d1));
      }

    // dQ += dS K over the tile's keys
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      Split as[4];
      frag_acc(as, dp[ks]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Split bk[2];
        frag_bn<HD>(bk, Ks, ks, nt, g, t);
        mma3(dqa[nt], as, bk);
      }
    }
    __syncthreads();  // this stage's K and V are read
  }
  cp_async_wait<0>();  // Q's copy, when no key is visible
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (gridDim.z > 1 &&
      !combine_splits<NT * 4>([&](int f) -> float& { return dqa[f / 4][f % 4]; },
                              part + (size_t)tile * gridDim.z * kTile * HD, counters + tile))
    return;

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = h2 ? row1 : row0;
    if (row >= Sq) continue;
    float* out = dq + ((size_t)bh * Sq + row) * hd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < hd)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(dqa[nt][2 * h2] * scale, dqa[nt][2 * h2 + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int q_offset,
                        cudaStream_t st, const WalkSplit& kv, const WalkSplit& qs) {
  constexpr int bytes = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(tf32_dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tf32_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd), scale_log2 = scale * kLog2e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const dim3 kv_grid(B * Hkv, (Sk + kTile - 1) / kTile, kv.n);
  tf32_dkdv_kernel<HD><<<kv_grid, kTcThreads, bytes, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), kv.part,
      kv.counters, Hq, Hkv, Sq, Sk, hd, causal, q_offset, scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tf32_dq_kernel<HD><<<dim3(B * Hq, (Sq + kTile - 1) / kTile, qs.n), kTcThreads, bytes, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), qs.part, qs.counters, Hq, Hkv, Sq,
      Sk, hd, causal, q_offset, scale, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any hd: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: ty = query / key group, tx = column group

// Rows [r0, r0 + 64) of a (rows, hd) matrix into a (64, HD + 4) f32 tile;
// rows >= nrows and columns >= hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int nrows, int hd) {
  constexpr int ld = HD + 4;
  if constexpr (sizeof(T) == 4) {
    if (hd % 4 == 0) {
      for (int i = threadIdx.x; i < kTile * HD / 4; i += kThreads) {
        const int rr = i / (HD / 4), c = (i % (HD / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + rr < nrows && c < hd)
          val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + rr) * hd + c);
        *reinterpret_cast<float4*>(dst + rr * ld + c) = val;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int rr = i / HD, c = i % HD;
    dst[rr * ld + c] = (r0 + rr < nrows && c < hd) ? to_f32(src[(size_t)(r0 + rr) * hd + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[4 ty + i][d] * B[tx + 16 j][d] over two (64, HD + 4) tiles
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bt,
                                         int ty, int tx) {
  constexpr int ld = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z + a[i].w * b[j].w;
  }
}

// P and dS of one (64 queries, 64 keys) tile into Ps and dSs ([query][key],
// rows of 64 + 4), from Q, dO, K, V tiles and the rows' lse and D.
template <int HD>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* dOs,
                                                  const float* Ks, const float* Vs,
                                                  const float* Ls, const float* Ds, float* Ps,
                                                  float* dSs, int q0, int k0, int Sk, int causal,
                                                  int q_offset, float scale, int ty, int tx) {
  constexpr int ldp = kTile + 4;
  float s[4][4], dp[4][4];
  tile_dot<HD>(s, Qs, Ks, ty, tx);
  tile_dot<HD>(dp, dOs, Vs, ty, tx);
  // a tile that crosses Sk or the causal diagonal masks key by key; rows past
  // Sq have lse = +inf and so P = 0
  const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i, qpos = q_offset + q0 + row;
    const float lse = Ls[row], dlt = Ds[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = k0 + tx + 16 * j;
      const bool ok = !edge || (kc < Sk && (!causal || qpos >= kc));
      const float p = ok ? expf(s[i][j] * scale - lse) : 0.f;
      Ps[row * ldp + tx + 16 * j] = p;
      dSs[row * ldp + tx + 16 * j] = p * (dp[i][j] - dlt);
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  // four (64, HD + 4) tiles, two (64, 68) tiles, lse and D of 64 rows
  return (int)sizeof(float) * (4 * kTile * (HD + 4) + 2 * kTile * (kTile + 4) + 2 * kTile);
}

// One block: keys [k0, k0 + 64) of KV head (b, hk) = blockIdx.x, k0 =
// 64 blockIdx.y.  Thread (ty, tx) accumulates dK and dV of keys 4 ty + i,
// columns 4 tx + 64 c + e.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Hq,
            int Hkv, int Sq, int Sk, int hd, int causal, int q_offset, float scale) {
  constexpr int ld = HD + 4, ldp = kTile + 4, NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;
  float* dSs = Ps + kTile * ldp;
  float* Ls = dSs + kTile * ldp;
  float* Ds = Ls + kTile;

  const int kvbh = blockIdx.x, b = kvbh / Hkv, hk = kvbh % Hkv, group = Hq / Hkv;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  load_tile<T, HD>(Ks, k + (size_t)kvbh * Sk * hd, k0, Sk, hd);
  load_tile<T, HD>(Vs, v + (size_t)kvbh * Sk * hd, k0, Sk, hd);

  float adk[4][NC][4], adv[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[i][c][e] = adv[i][c][e] = 0.f;

  // queries before k0 - q_offset see none of these keys
  const int first = causal ? max(0, k0 - q_offset) / kTile : 0;
  const int nq = (Sq + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int bh = b * Hq + hk * group + g;
    const T* qb = q + (size_t)bh * Sq * hd;
    const T* dob = dout + (size_t)bh * Sq * hd;
    for (int t = first; t < nq; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_tile<T, HD>(Qs, qb, q0, Sq, hd);
      load_tile<T, HD>(dOs, dob, q0, Sq, hd);
      if (tid < kTile) {
        const int r = q0 + tid;
        Ls[tid] = r < Sq ? lse[(size_t)bh * Sq + r] : INFINITY;
        Ds[tid] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
      }
      __syncthreads();
      probs_and_dscores<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Sk, causal, q_offset,
                            scale, ty, tx);
      __syncthreads();
      // dV[key] += P[q][key] dO[q];  dK[key] += dS[q][key] Q[q]
#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + qq * ldp + 4 * ty);
        const float4 sv = *reinterpret_cast<const float4*>(dSs + qq * ldp + 4 * ty);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 ov = *reinterpret_cast<const float4*>(dOs + qq * ld + 4 * tx + 64 * c);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + qq * ld + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = pick(pv, i), ds = pick(sv, i);
            adv[i][c][0] += p * ov.x;
            adv[i][c][1] += p * ov.y;
            adv[i][c][2] += p * ov.z;
            adv[i][c][3] += p * ov.w;
            adk[i][c][0] += ds * qv.x;
            adk[i][c][1] += ds * qv.y;
            adk[i][c][2] += ds * qv.z;
            adk[i][c][3] += ds * qv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Sk) continue;
    T* dkr = dk + ((size_t)kvbh * Sk + key) * hd;
    T* dvr = dv + ((size_t)kvbh * Sk + key) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < hd) {
          store(dkr + d, adk[i][c][e] * scale);
          store(dvr + d, adv[i][c][e]);
        }
      }
  }
}

// One block: queries [q0, q0 + 64) of (b, h) = blockIdx.x, tiles from the
// last.  Thread (ty, tx) accumulates dQ of queries 4 ty + i, columns
// 4 tx + 64 c + e.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
          int hd, int causal, int q_offset, float scale) {
  constexpr int ld = HD + 4, ldp = kTile + 4, NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;
  float* dSs = Ps + kTile * ldp;
  float* Ls = dSs + kTile * ldp;
  float* Ds = Ls + kTile;

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* kb = k + (size_t)kvbh * Sk * hd;
  const T* vb = v + (size_t)kvbh * Sk * hd;
  load_tile<T, HD>(Qs, q + (size_t)bh * Sq * hd, q0, Sq, hd);
  load_tile<T, HD>(dOs, dout + (size_t)bh * Sq * hd, q0, Sq, hd);
  if (tid < kTile) {
    const int r = q0 + tid;
    Ls[tid] = r < Sq ? lse[(size_t)bh * Sq + r] : INFINITY;
    Ds[tid] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  // keys past k_end are invisible to every query of this block
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kTile, Sq)) : Sk;
  const int nk = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K and V are read
    load_tile<T, HD>(Ks, kb, k0, Sk, hd);
    load_tile<T, HD>(Vs, vb, k0, Sk, hd);
    __syncthreads();
    probs_and_dscores<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Sk, causal, q_offset, scale,
                          ty, tx);
    __syncwarp();  // a query row's dS comes from its own half-warp
    // dQ[q] += dS[q][key] K[key]
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(dSs + (4 * ty + i) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (j + jj) * ld + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = pick(sv[i], jj);
            acc[i][c][0] += ds * kv.x;
            acc[i][c][1] += ds * kv.y;
            acc[i][c][2] += ds * kv.z;
            acc[i][c][3] += ds * kv.w;
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    T* dqr = dq + ((size_t)bh * Sq + row) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < hd) store(dqr + d, acc[i][c][e] * scale);
      }
  }
}

template <typename T, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int q_offset,
                        cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd);
  dkdv_kernel<T, HD><<<dim3(B * Hkv, (Sk + kTile - 1) / kTile), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
      Sq, Sk, hd, causal, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3(B * Hq, (Sq + kTile - 1) / kTile), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, hd, causal,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Hq, Sq, hd); k, v, dk, dv: (B, Hkv, Sk, hd); lse and
// delta (scratch for D): (B, Hq, Sq) f32; all contiguous on the device.
// dtype 0 = float32, 1 = bfloat16; route 1 = the tensor cores (3xTF32 for
// f32 with hd % 4 == 0 and hd <= 64, wgmma for bf16 with hd % 8 == 0), 0 =
// the CUDA cores (any hd).  The tensor-core route splits the walk of each dK/dV tile
// over nsplit_kv blocks and of each dQ tile over nsplit_q; where either is
// above 1, part holds (B Hkv nk nsplit_kv 2 + B Hq nq nsplit_q) 64 HD f32
// partial sums (a term whose split is 1 takes no room; nk, nq: tiles of
// 64 keys and queries, HD: hd rounded up to 64 or 128) and counters
// B Hkv nk + B Hq nq int32 zeros, which the kernels leave zero.  Returns
// the first launch error (cudaError_t, 0 when all three launches were
// accepted).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int hd, int causal, int q_offset, int dtype, int route,
                                   int nsplit_kv, int nsplit_q, float* part, int* counters,
                                   void* stream) {
  const bool split = nsplit_kv > 1 || nsplit_q > 1;
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd > 128 || Hq % Hkv != 0 ||
      (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535 ||
      (dtype != 0 && dtype != 1) || (route != 0 && route != 1) ||
      (route == 1 && (dtype == 0 ? hd % 4 != 0 || hd > 64 : hd % 8 != 0)) ||
      nsplit_kv < 1 || nsplit_q < 1 || nsplit_kv > 64 || nsplit_q > 64 ||
      (split && (route == 0 || !part || !counters)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * Hq * Sq;
  cudaError_t err = dtype == 0 ? launch_dot<float>(o, dout, delta, rows, hd, st)
                               : launch_dot<bf16>(o, dout, delta, rows, hd, st);
  if (err != cudaSuccess) return err;
  // the dQ kernel's scratch and counters come after the dK/dV kernel's
  const size_t kv_tiles = (size_t)B * Hkv * ((Sk + kTile - 1) / kTile);
  const size_t kv_floats =
      nsplit_kv > 1 ? kv_tiles * nsplit_kv * 2 * kTile * (hd <= 64 ? 64 : 128) : 0;
  const WalkSplit kv{nsplit_kv, part, counters};
  const WalkSplit qs{nsplit_q, part ? part + kv_floats : nullptr,
                     counters ? counters + kv_tiles : nullptr};
#define ARGS q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st
  if (dtype == 0) {
    if (route == 1) return launch_tf32<64>(ARGS, kv, qs);
    return hd <= 64 ? launch_simt<float, 64>(ARGS) : launch_simt<float, 128>(ARGS);
  }
  if (route == 1)
    return hd <= 64 ? launch_wgmma<64>(ARGS, kv, qs) : launch_wgmma<128>(ARGS, kv, qs);
  return hd <= 64 ? launch_simt<bf16, 64>(ARGS) : launch_simt<bf16, 128>(ARGS);
#undef ARGS
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
