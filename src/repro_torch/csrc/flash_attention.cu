// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// key tiles, causal or not, with a query offset and grouped KV heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention).  Same function: query i of
// a block sits at position q_offset + i, keys k < Sk are valid, a causal
// query sees keys k <= its position, query head h reads KV head h / group,
// and (m, l, acc) accumulate in f32 with m starting at -1e30 and the output
// acc / max(l, 1e-30), so a row with no visible key gives 0.
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
//  * bf16 (hd a multiple of 8, at most 128): tensor cores.  One warpgroup
//    (128 threads) owns 64 query rows of one (b, h); two blocks share an
//    SM.  S = Q K^T is wgmma.mma_async m64n64k16 with Q and K read from
//    shared memory; the f32 scores are scaled (in the exponent, never in a
//    rounded Q), masked only on tiles that cross the diagonal or Sk, and
//    turned into P in registers, rounded to bf16 and fed back as the A
//    operand of O += P V (wgmma m64n64k16 per 64 columns of hd, V read from
//    shared memory MN-major, i.e. with the transpose bit).  Q, K and V tiles
//    (64 rows by 64 columns, 128-byte swizzle matching the wgmma
//    descriptors) arrive by TMA from 3-D tensor maps (hd, S, B * H), whose
//    out-of-bounds fill zeroes ragged tiles without reading the next head;
//    K/V come through a ring of two stages with mbarriers, the next tile's
//    copy in flight while the current one is multiplied.
//  * f32 (and bf16 whose hd TMA cannot describe): CUDA cores, products in
//    f32 (a TF32 pass keeps ~3 digits, short of the 3e-5 tolerance).  A
//    block of 256 threads owns 64 query rows; each thread holds a 4 x 4 tile
//    of S and a 4 x (hd / 16) tile of O in registers, so that 8 shared
//    loads of 16 bytes feed 64 FMAs; K/V tiles of 64 keys arrive by cp.async
//    into two stages.
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

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                 // query rows per block = keys per tile
constexpr int kSlice = kTile * 64;        // elements of one 64 x 64 slice (8 KB)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the barrier's phase `parity` to complete.  A copy that never
// lands (a fault of the tensor map) traps after ~2^26 polls, some seconds,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int HD>
constexpr int wg_smem_bytes() {
  // Q, two stages of (K, V), three mbarriers, and slack for 1024-byte alignment
  return (HD / 64) * kSlice * 2 * 5 + 8 * 3 + 1024;
}

// One block, one warpgroup: 64 query rows (tile blockIdx.x, counted from the
// last so the longest causal blocks start first) of (b, h) = blockIdx.y;
// two blocks share an SM, so one's softmax runs beside the other's products.
// Maps: q (hd, Sq, B * Hq), k and v (hd, Sk, B * Hkv), boxes (64, 64, 1).
// Each group of products is a stage of its own (fence, products, wait):
// issuing tile t's S with tile t - 1's P V in one stage, so that the softmax
// overlaps them, made ptxas serialize every wgmma (C7513) and ran slower.
template <int HD>
__global__ void __launch_bounds__(128)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
             float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
             int q_offset, float scale_log2) {
  constexpr int NS = HD / 64;                       // 64-column slices of hd
  constexpr uint32_t kTileBytes = NS * kSlice * 2;  // one Q, K or V tile
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* KVs = Qs + NS * kSlice;                     // stage s: K at 2s NS, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + 4 * NS * kSlice);  // q, full[2]

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys past k_end are invisible to every query of this block
  const int k_end = causal ? min(Sk, q_offset + min(q0 + kTile, Sq)) : Sk;
  const int n = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  auto issue_kv = [&](int t, int stage) {
    bf16* Ks = KVs + stage * 2 * NS * kSlice;
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
    mbar_expect_tx(&bars[0], kTileBytes);
#pragma unroll
    for (int s = 0; s < NS; ++s) tma_load_3d(Qs + s * kSlice, &qmap, &bars[0], s * 64, q0, bh);
    if (n > 0) issue_kv(0, 0);
  }

  // this thread's rows of the 64: r and r + 8; its columns of each 8-column
  // block j: 8j + 2 * (lane % 4) + {0, 1}
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int qpos0 = q_offset + q0 + r, qpos1 = qpos0 + 8;
  float o[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
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
    const bf16* Ks = KVs + stage * 2 * NS * kSlice;
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
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[s][4 * j] *= corr0;
        o[s][4 * j + 1] *= corr0;
        o[s][4 * j + 2] *= corr1;
        o[s][4 * j + 3] *= corr1;
      }

    wgmma_fence();
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)  // 16 keys = 16 rows of 128 bytes
        wgmma_rs(o[s], pa[kk], desc_sw128(Vs + s * kSlice + kk * 16 * 64, 64 * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) fence_regs(o[s]);
    __syncthreads();
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + (size_t)bh * Sq * hd;
  const int row0 = q0 + r, row1 = row0 + 8;
  if (lse != nullptr && lane % 4 == 0) {  // m in units of log2: lse = (m + log2 l) ln 2
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (row1 < Sq) lse[(size_t)bh * Sq + row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = s * 64 + 8 * j + cq;
      if (col < hd) {
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * hd + col) =
              __floats2bfloat162_rn(o[s][4 * j] * inv0, o[s][4 * j + 1] * inv0);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * hd + col) =
              __floats2bfloat162_rn(o[s][4 * j + 2] * inv1, o[s][4 * j + 3] * inv1);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (the
// runtime does not export it, and linking libcuda would tie the build to a
// library at a fixed path)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (hd, S, BH) bf16 tensor map with (64, 64, 1) boxes, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int BH) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
                         int q_offset, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, hd, Sq, B * Hq) || !make_map(&km, k, hd, Sk, B * Hkv) ||
      !make_map(&vm, v, hd, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  constexpr int bytes = wg_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((Sq + kTile - 1) / kTile, B * Hq);
  wgmma_kernel<HD><<<grid, 128, bytes, st>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, Hq, Hkv, Sq, Sk, hd, causal, q_offset,
      1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: register-tiled CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: ty = query group, tx = key / column group

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

template <int HD>
constexpr int simt_smem_bytes() {
  // Q, two stages of (K, V), P
  return (int)sizeof(float) * (5 * kTile * (HD + 4) + kTile * (kTile + 4));
}

// One block: 64 query rows (tile blockIdx.x, from the last) of (b, h) =
// blockIdx.y.  Thread (ty, tx) owns query rows 4 ty + i, score columns
// tx + 16 j and output columns 4 tx + 64 c + e.
template <typename T, int HD>
__global__ void __launch_bounds__(kSimtThreads, HD == 128 ? 1 : 2)  // as shared memory allows
simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
            int hd, int causal, int q_offset, float scale) {
  constexpr int ld = HD + 4, ldp = kTile + 4, NC = HD / 64;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;                       // [64][ld]
  float* KV = Qs + kTile * ld;             // stage s: K at 2s, V at 2s + 1, [64][ld] each
  float* Ps = KV + 4 * kTile * ld;         // [64][ldp]

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + (size_t)bh * Sq * hd;
  const T* kb = k + (size_t)kvbh * Sk * hd;
  const T* vb = v + (size_t)kvbh * Sk * hd;
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kTile, Sq));
  const int ntiles = k_end > 0 ? (k_end + kTile - 1) / kTile : 0;

  load_rows<T, HD>(Qs, qb, q0, Sq, hd);
  if (ntiles > 0) {
    load_rows<T, HD>(KV, kb, 0, Sk, hd);
    load_rows<T, HD>(KV + kTile * ld, vb, 0, Sk, hd);
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
    const float* Ks = KV + (t & 1) * 2 * kTile * ld;
    const float* Vs = Ks + kTile * ld;
    if (t + 1 < ntiles) {  // the other stage was released at the end of t - 1
      float* Kn = KV + ((t + 1) & 1) * 2 * kTile * ld;
      load_rows<T, HD>(Kn, kb, k0 + kTile, Sk, hd);
      load_rows<T, HD>(Kn + kTile * ld, vb, k0 + kTile, Sk, hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
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
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (j + jj) * ld + 4 * tx + 64 * c);
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
    T* ob = out + ((size_t)bh * Sq + row) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c + e;
        if (d < hd) store(ob + d, acc[i][c][e] * inv);
      }
  }
}

template <typename T, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
                        int q_offset, cudaStream_t st) {
  constexpr int bytes = simt_smem_bytes<HD>();
  static_assert(bytes <= kMaxSmem, "shared memory");
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        simt_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((Sq + kTile - 1) / kTile, B * Hq);
  simt_kernel<T, HD><<<grid, kSimtThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Hq, Hkv, Sq, Sk, hd, causal, q_offset,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_hd(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
                           int q_offset, cudaStream_t st) {
  if (hd <= 64)
    return launch_simt<T, 64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  if (hd <= 128)
    return launch_simt<T, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd); all contiguous on the
// device; lse: (B, Hq, Sq) f32, or null.  dtype 0 = float32, 1 = bfloat16.
// bf16 with hd a multiple of 8 runs the tensor-core kernel; f32, and bf16
// rows TMA cannot describe, the CUDA-core one.  Returns the launch's cudaError_t (0 when it was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int hd, int causal, int q_offset,
                               int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd > 128 || Hq % Hkv != 0 ||
      B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_simt_hd<float>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset,
                                 st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (hd % 8 != 0)
    return launch_simt_hd<bf16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  if (hd <= 64)
    return launch_wgmma<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  return launch_wgmma<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
