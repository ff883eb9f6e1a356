// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// key tiles, causal or not, with a query offset and grouped KV heads.  Q and
// K are hd wide (up to 192), V and the output hd_v wide (hd_v <= hd, in
// hd's 64-wide class up to 128, or hd in (128, 192] with hd_v in (64, 128]):
// MLA's expanded prefill runs hd 192 (nope 128 + rope 64) with hd_v 128.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention).  Same function: query i of
// a block sits at position q_offset + i, keys k < Sk are valid, a causal
// query sees keys k <= its position, query head h reads KV head h / group,
// and (m, l, acc) accumulate in f32 with m starting at -1e30 and the output
// acc / max(l, 1e-30), so a row with no visible key gives 0.  The scale is
// 1 / sqrt(hd), hd the width of Q, as in the reference whatever V's width.
//
// What bounds it on this card.  A causal pass over S keys does about
// 2 * B * Hq * S^2 * hd FLOPs on 4 * B * Hq * S * hd elements read or
// written.  In f32 that is S / 8 FLOPs per byte against the card's ~20
// (67 TFLOP/s over 3.35 TB/s): operations bind from S = 160 on, so the
// main path's f32 prefill (S = 256) is bound by the CUDA cores' FMA rate.
// In bf16 it is S / 4 against the tensor cores' ~295: bytes bind below S of
// about 1,200, and at the shapes served the time is set by how fast the
// products run, how well loads overlap them and how full the grid is.
//
// Two kernels, one per path, both keeping every intermediate on the chip
// (the (Sq, Sk) score matrix never reaches device memory) and stopping a
// causal block at its last visible key:
//
//  * bf16 (hd and hd_v multiples of 8): tensor cores.  One warpgroup
//    (128 threads) owns 64 query rows of one (b, h); two blocks share an
//    SM.  S = Q K^T is wgmma.mma_async m64n64k16 with Q and K read from
//    shared memory (hd / 16 steps of k: 12 at hd 192); the f32 scores are
//    scaled (in the exponent, never in a rounded Q), masked only on tiles
//    that cross the diagonal or Sk, and turned into P in registers, rounded
//    to bf16 and fed back as the A operand of O += P V (wgmma m64n64k16 per
//    64 columns of hd_v, V read from shared memory MN-major, i.e. with the
//    transpose bit; O stays 64 x hd_v in registers).  Q, K and V tiles (64
//    rows by 64 columns, 128-byte swizzle matching the wgmma descriptors:
//    three boxes a row of Q or K at hd 192) arrive by TMA from 3-D tensor
//    maps (width, S, B * H), whose out-of-bounds fill zeroes ragged tiles
//    without reading the next head; K/V come through a ring of two stages
//    with mbarriers, the next tile's copy in flight while the current one is
//    multiplied (at hd 192, hd_v 128: 24 KB of Q and 40 KB of K and V a
//    stage, 105 KB, two blocks an SM).
//  * f32 (and bf16 whose hd or hd_v TMA cannot describe): CUDA cores,
//    products in f32 (a TF32 pass keeps ~3 digits, short of the 3e-5
//    tolerance).  A block of 256 threads owns 64 query rows; each thread
//    holds a 4 x 4 tile of S and a 4 x (hd_v / 16) tile of O in registers,
//    so that 8 shared loads of 16 bytes feed 64 FMAs; K/V tiles of 64 keys
//    arrive by cp.async into two stages, or one where two do not fit shared
//    memory (hd 192: the (64, width + 4) f32 tiles of Q, K, V and P take
//    152 KB at hd_v 128 with one stage, 236 KB with two).
//
// Both write each query row's log-sum-exp of its scaled visible scores
// (natural log, f32; +inf for a row with no visible key) when given an lse
// pointer: the backward (flash_attention_bwd.cu) recomputes the
// probabilities from it.  Serving passes null and writes nothing more.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                 // query rows per block = keys per tile
constexpr int kSlice = kTile * 64;        // elements of one 64 x 64 slice (8 KB)

template <int HD, int HDV>
constexpr int wg_smem_bytes() {
  // Q, two stages of (K, V), three mbarriers, and slack for 1024-byte alignment
  return (HD / 64 + 2 * (HD / 64 + HDV / 64)) * kSlice * 2 + 8 * 3 + 1024;
}

// One block, one warpgroup: 64 query rows (tile blockIdx.x, counted from the
// last so the longest causal blocks start first) of (b, h) = blockIdx.y;
// two blocks share an SM, so one's softmax runs beside the other's products.
// Maps: q (hd, Sq, B * Hq), k (hd, Sk, B * Hkv), v (hd_v, Sk, B * Hkv),
// boxes (64, 64, 1).  HD and HDV: hd and hd_v rounded up to 64.
// Each group of products is a stage of its own (fence, products, wait):
// issuing tile t's S with tile t - 1's P V in one stage, so that the softmax
// overlaps them, made ptxas serialize every wgmma (C7513) and ran slower.
template <int HD, int HDV>
__global__ void __launch_bounds__(128)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
             float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int hd_v, int causal,
             int q_offset, float scale_log2) {
  constexpr int NS = HD / 64;                        // 64-column slices of hd
  constexpr int NSV = HDV / 64;                      // and of hd_v
  constexpr uint32_t kTileBytes = NS * kSlice * 2;   // one Q or K tile
  constexpr uint32_t kVTileBytes = NSV * kSlice * 2; // one V tile
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* KVs = Qs + NS * kSlice;                     // stage s: K at s (NS + NSV), V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + 2 * (NS + NSV) * kSlice);  // q, full[2]

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys past k_end are invisible to every query of this block
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kTile, Sq)) : Sk;
  const int n = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  auto issue_kv = [&](int t, int stage) {
    bf16* Ks = KVs + stage * (NS + NSV) * kSlice;
    bf16* Vs = Ks + NS * kSlice;
    mbar_expect_tx(&bars[1 + stage], kTileBytes + kVTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load_3d(Ks + s * kSlice, &kmap, &bars[1 + stage], s * 64, t * kTile, kvbh);
      if (s < NSV) tma_load_3d(Vs + s * kSlice, &vmap, &bars[1 + stage], s * 64, t * kTile, kvbh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) tma_load_3d(Qs + s * kSlice, &qmap, &bars[0], s * 64, q0, bh);
    if (n > 0) issue_kv(0, 0);
  }

  // this thread's rows of the 64: r and r + 8; its columns of each 8-column
  // block j: 8j + 2 * (lane % 4) + {0, 1}
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int qpos0 = q_offset + q0 + r, qpos1 = qpos0 + 8;
  float o[NSV][32];
#pragma unroll
  for (int s = 0; s < NSV; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in units of log2

  mbar_wait(&bars[0], 0);
  for (int t = 0; t < n; ++t) {
    const int stage = t & 1;
    // the other stage was last read in tile t - 1, which the warpgroup has
    // finished (the __syncthreads at the end of the loop)
    if (tid == 0 && t + 1 < n) issue_kv(t + 1, stage ^ 1);
    mbar_wait(&bars[1 + stage], (t >> 1) & 1);
    const bf16* Ks = KVs + stage * (NS + NSV) * kSlice;
    const bf16* Vs = Ks + NS * kSlice;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * kSlice + (kk % 4) * 16;  // 32 bytes a k step, then the next slice
      wgmma_ss(sc, desc_sw128(Qs + off, 16, 1024), desc_sw128(Ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = t * kTile;
    if (k0 + kTile > Sk || (causal && k0 + kTile - 1 > q_offset + q0)) {  // edge tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kc = k0 + 8 * j + cq + c;
          if (kc >= Sk || (causal && qpos0 < kc)) sc[4 * j + c] = -INFINITY;
          if (kc >= Sk || (causal && qpos1 < kc)) sc[4 * j + 2 + c] = -INFINITY;
        }
    }
    // the scale goes into the exponent: scale > 0, so the max of the scaled
    // scores is the scaled max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[4][4];  // P as the A operand, one 16-key step each
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
    for (int s = 0; s < NSV; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[s][4 * j] *= corr0;
        o[s][4 * j + 1] *= corr0;
        o[s][4 * j + 2] *= corr1;
        o[s][4 * j + 3] *= corr1;
      }

    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NSV; ++s)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(o[s], pa[kk], desc_sw128(Vs + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NSV; ++s) fence_regs(o[s]);
    __syncthreads();
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + (size_t)bh * Sq * hd_v;
  const int row0 = q0 + r, row1 = row0 + 8;
  if (lse != nullptr && lane % 4 == 0) {  // m in units of log2: lse = (m + log2 l) ln 2
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (row1 < Sq) lse[(size_t)bh * Sq + row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
#pragma unroll
  for (int s = 0; s < NSV; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = s * 64 + 8 * j + cq;
      if (col < hd_v) {
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * hd_v + col) =
              __floats2bfloat162_rn(o[s][4 * j] * inv0, o[s][4 * j + 1] * inv0);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * hd_v + col) =
              __floats2bfloat162_rn(o[s][4 * j + 2] * inv1, o[s][4 * j + 3] * inv1);
      }
    }
}

template <int HD, int HDV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int Hq, int Hkv, int Sq, int Sk, int hd, int hd_v, int causal,
                         int q_offset, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, hd, Sq, B * Hq) || !make_map(&km, k, hd, Sk, B * Hkv) ||
      !make_map(&vm, v, hd_v, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  constexpr int bytes = wg_smem_bytes<HD, HDV>();
  static_assert(bytes <= kMaxSmem, "shared memory");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((Sq + kTile - 1) / kTile, B * Hq);
  wgmma_kernel<HD, HDV><<<grid, 128, bytes, st>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, Hq, Hkv, Sq, Sk, hd_v, causal, q_offset,
      1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: register-tiled CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: ty = query group, tx = key / column group

// Rows [r0, r0 + 64) of a (rows, hd) matrix into a (64, HD + 4) f32 tile;
// rows >= nrows and columns >= hd are zero.  cp.async for f32 rows of whole
// 16-byte pieces, converting loads otherwise.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int nrows, int hd) {
  constexpr int ld = HD + 4;
  if constexpr (sizeof(T) == 4) {
    if (hd % 4 == 0) {
      const int nv = hd / 4;
      for (int i = threadIdx.x; i < kTile * HD / 4; i += kSimtThreads) {
        const int rr = i / (HD / 4), c = (i % (HD / 4)) * 4;
        float* d = dst + rr * ld + c;
        if (r0 + rr < nrows && c / 4 < nv)
          cp_async16(d, src + (size_t)(r0 + rr) * hd + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kTile * HD; i += kSimtThreads) {
    const int rr = i / HD, c = i % HD;
    dst[rr * ld + c] = (r0 + rr < nrows && c < hd) ? to_f32(src[(size_t)(r0 + rr) * hd + c]) : 0.f;
  }
}

template <int HD, int HDV, int STAGES>
__host__ __device__ constexpr int simt_smem_bytes() {
  // Q, STAGES stages of (K, V), P
  return (int)sizeof(float) *
         (kTile * (HD + 4) + STAGES * kTile * (HD + 4 + HDV + 4) + kTile * (kTile + 4));
}

// K/V stages of the CUDA-core kernel: two where they fit shared memory
template <int HD, int HDV>
__host__ __device__ constexpr int simt_stages() {
  return simt_smem_bytes<HD, HDV, 2>() <= kMaxSmem ? 2 : 1;
}

// One block: 64 query rows (tile blockIdx.x, from the last) of (b, h) =
// blockIdx.y.  Thread (ty, tx) owns query rows 4 ty + i, score columns
// tx + 16 j and output columns 4 tx + 64 c + e.  HD and HDV: hd and hd_v
// rounded up to 64.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kSimtThreads, HD == 64 ? 2 : 1)  // as shared memory allows
simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
            int hd, int hd_v, int causal, int q_offset, float scale) {
  constexpr int ld = HD + 4, ldv = HDV + 4, ldp = kTile + 4, NC = HDV / 64;
  constexpr int STAGES = simt_stages<HD, HDV>();
  constexpr int kStage = kTile * (ld + ldv);  // floats of one stage: K [64][ld], V [64][ldv]
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;                       // [64][ld]
  float* KV = Qs + kTile * ld;             // stage s at s * kStage
  float* Ps = KV + STAGES * kStage;        // [64][ldp]

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * Sq * hd;
  const T* kb = k + (size_t)kvbh * Sk * hd;
  const T* vb = v + (size_t)kvbh * Sk * hd_v;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kTile, Sq));
  const int ntiles = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  load_rows<T, HD>(Qs, qb, q0, Sq, hd);
  if (ntiles > 0) {
    load_rows<T, HD>(KV, kb, 0, Sk, hd);
    load_rows<T, HDV>(KV + kTile * ld, vb, 0, Sk, hd_v);
  }
  cp_async_commit();

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kTile;
    float* Ks = KV + (STAGES == 2 ? (t & 1) : 0) * kStage;
    const float* Vs = Ks + kTile * ld;
    if (STAGES == 2) {
      if (t + 1 < ntiles) {  // the other stage was released at the end of t - 1
        float* Kn = KV + ((t + 1) & 1) * kStage;
        load_rows<T, HD>(Kn, kb, k0 + kTile, Sk, hd);
        load_rows<T, HDV>(Kn + kTile * ld, vb, k0 + kTile, Sk, hd_v);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {  // one stage: tile t goes into it once t - 1 has released it
      if (t > 0) {
        load_rows<T, HD>(Ks, kb, k0, Sk, hd);
        load_rows<T, HDV>(Ks + kTile * ld, vb, k0, Sk, hd_v);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = !edge || (kc < Sk && (!causal || qpos >= kc));
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o_ = 1; o_ < 16; o_ <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncwarp();  // a row's probabilities come from its own half-warp

#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (j + jj) * ldv + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] += p * vv.x;
            acc[i][c][1] += p * vv.y;
            acc[i][c][2] += p * vv.z;
            acc[i][c][3] += p * vv.w;
          }
        }
      }
    }
    __syncthreads();  // K, V and P of this tile are read
  }
  cp_async_wait<0>();  // Q's copy, when no tile was visible

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o_ = 1; o_ < 16; o_ <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o_);
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + row] = lt > 0.f ? m[i] + logf(lt) : INFINITY;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    T* ob = out + ((size_t)bh * Sq + row) * hd_v;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < hd_v) store(ob + d, acc[i][c][e] * inv);
      }
  }
}

template <typename T, int HD, int HDV>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Sk, int hd, int hd_v, int causal,
                        int q_offset, cudaStream_t st) {
  constexpr int bytes = simt_smem_bytes<HD, HDV, simt_stages<HD, HDV>()>();
  static_assert(bytes <= kMaxSmem, "shared memory");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        simt_kernel<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((Sq + kTile - 1) / kTile, B * Hq);
  simt_kernel<T, HD, HDV><<<grid, kSimtThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk, hd, hd_v, causal, q_offset,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

// The instantiations: hd and hd_v rounded up to 64 to one width (64 or 128),
// or to 192 and 128 (MLA's expanded attention).  The C entry refuses other
// pairs.
#define FA_ARGS q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, q_offset, st
template <typename T>
cudaError_t launch_simt_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int Hq, int Hkv, int Sq, int Sk, int hd, int hd_v, int causal,
                           int q_offset, cudaStream_t st) {
  if (hd <= 64) return launch_simt<T, 64, 64>(FA_ARGS);
  if (hd <= 128) return launch_simt<T, 128, 128>(FA_ARGS);
  return launch_simt<T, 192, 128>(FA_ARGS);
}

}  // namespace

// q: (B, Hq, Sq, hd); k: (B, Hkv, Sk, hd); v: (B, Hkv, Sk, hd_v); out: (B, Hq,
// Sq, hd_v); all contiguous on the device; hd_v <= hd, both in one 64-wide
// class up to 128, or hd in (128, 192] with hd_v in (64, 128]; lse: (B,
// Hq, Sq) f32, or null.  dtype 0 = float32, 1 = bfloat16.  bf16 with hd and
// hd_v multiples of 8 runs the tensor-core kernel; f32, and bf16 rows TMA
// cannot describe, the CUDA-core one.  Returns the launch's cudaError_t (0
// when it was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int hd, int hd_v, int causal, int q_offset,
                               int dtype, void* stream) {
  const int w = (hd + 63) / 64, wv = (hd_v + 63) / 64;  // 64-column slices
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd_v <= 0 || hd_v > hd ||
      !((w == wv && w <= 2) || (w == 3 && wv == 2)) || Hq % Hkv != 0 || B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_simt_hd<float>(FA_ARGS);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (hd % 8 != 0 || hd_v % 8 != 0) return launch_simt_hd<bf16>(FA_ARGS);
  if (hd <= 64) return launch_wgmma<64, 64>(FA_ARGS);
  if (hd <= 128) return launch_wgmma<128, 128>(FA_ARGS);
  return launch_wgmma<192, 128>(FA_ARGS);
}
#undef FA_ARGS

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
