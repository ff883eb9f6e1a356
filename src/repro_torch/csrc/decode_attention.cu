// Flash-decode for Hopper (sm_90a): one query token per (batch row, query
// head) against a KV cache, each batch row at its own length, split over the
// KV axis (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention).  It computes the same
// function with one change of interface: kv_len is a (B,) int32 vector on the
// device, so slots at different depths share one launch (the TPU kernel takes
// one scalar length for the whole batch).  The kernels read kv_len
// themselves; the host never waits to learn it.  Any GQA group Hq / Hkv is
// taken, as the TPU kernel takes it.
//
// What bounds it on this card: bytes.  A (b, kv head) pair reads each of its
// kv_len[b] valid K and V rows once (2 * kv_len * hd elements) and does
// 4 * group * hd FLOPs per row pair: group / 2 FLOPs per byte in f32, where
// the card needs about 20 (67 TFLOP/s over 3.35 TB/s) before compute binds.
//
// What the design does about it:
//  * the TPU grid's sequential KV axis becomes a parallel one: the grid is
//    (B * Hkv, nsplit, query-head chunks of 16), each block takes one chunk
//    of keys.  The wrapper picks nsplit from S, B * Hkv and the SM count:
//    about two blocks per SM, except one query per KV head (group 1), whose
//    blocks take up to four 256-key tiles unsplit, a split's merge costing
//    more than it saves there;
//  * a block stops at kv_len[b]: a chunk at or past it writes m = -1e30,
//    l = 0 and reads nothing;
//  * K/V tiles arrive in shared memory by cp.async (16-byte copies, rows
//    padded by 16 bytes so that lanes reading different rows hit different
//    banks), two tiles in flight where a chunk has more than one and shared
//    memory holds two;
//  * no per-key dependent chain: one max, one sum and one rescale per tile
//    and head.  Two kernels:
//    - bf16 with a group of 5 or more (hd 64 or 128): tensor cores.  The
//      chunk's query heads, padded to 16, are the rows of mma.sync m16n8k16
//      (S = Q K^T with K's fragments read straight from the tile, then
//      O += P V with P from S's accumulators in bf16 and V by
//      ldmatrix.trans); four warps take 16 keys each of a 64-key tile;
//    - otherwise CUDA cores: 8 warps share a tile by heads when the group
//      (a template parameter padded to 1, 2, 4, 8 or 16; heads past it are
//      masked) has 8 or more, else by keys (tiles of up to 256 keys).  A
//      warp computes its tile's scores with one lane per key, loading each
//      K piece once for all its heads, then P.V with its lanes over hd;
//    groups above 16 run in chunks of 16 along the grid's third axis, and
//    the warps of a block merge their states in shared memory.
// The splits' (m, l, acc) partials go to a workspace the wrapper allocates;
// the last block of a (row, KV head) to finish, found with an atomic counter
// that it then resets, merges them, so a call is one launch.  With one split
// a block writes the output itself.  (m, l, acc) are f32 throughout, m
// starts at -1e30 and the output is acc / max(l, 1e-30), so a row with no
// valid key gives 0, as on the TPU.  On request each query row's log-sum-exp
// (m + log l; -inf with no valid key) goes out beside it, so that calls over
// disjoint key ranges of one cache (a cache sharded by keys) merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxChunk = 16;  // query heads per block at most
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 16 bytes of a row starting at p (4 floats or 8 bf16), as f32.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  // a bf16 is the high half of the f32 with the same value
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
  x[4] = __uint_as_float(t.z << 16); x[5] = __uint_as_float(t.z & 0xffff0000u);
  x[6] = __uint_as_float(t.w << 16); x[7] = __uint_as_float(t.w & 0xffff0000u);
}

// EPL (1, 2 or 4) consecutive elements of a row starting at p, as f32.
template <int EPL>
__device__ __forceinline__ void load_row(const float* p, float* x) {
  if constexpr (EPL == 4) {
    load16(p, x);
  } else if constexpr (EPL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}
template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* x) {
  if constexpr (EPL == 1) {
    x[0] = __bfloat162float(p[0]);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; e += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
      x[e] = t.x; x[e + 1] = t.y;
    }
  }
}

template <typename T, int HD>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                 // elements per 16 bytes
  static constexpr int kRow = HD + kVec;                       // padded row, elements
};

// Warps of the CUDA-core kernel: WH across the group's (padded) heads, WK
// across keys, 8 in all where a tile of TK = 32 * WK keys fits shared memory
// (kernels/decode_attention/ops.py:_key_tile computes the same TK).
template <typename T, int HD, int GP>
struct Split {
  static constexpr int WH = GP < 8 ? GP : 8;
  static constexpr int WK = (8 / WH > 4 && Layout<T, HD>::kRow * sizeof(T) > 280) ? 4 : 8 / WH;
  static constexpr int NW = WH * WK, NT = 32 * NW;
  static constexpr int HPW = GP / WH, TK = 32 * WK;
};

// Stage `nrows` rows of k and v from row r0 into a tile (NT threads); rows
// [nrows, zero_to) of the tile are zeroed, for kernels that multiply them.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_tile(T* Ks, T* Vs, const T* kb, const T* vb,
                                          int r0, int nrows, int hd, bool vec_ok,
                                          int zero_to = 0) {
  constexpr int kVec = Layout<T, HD>::kVec, kRow = Layout<T, HD>::kRow;
  const int nv = (hd + kVec - 1) / kVec;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < nrows * nv; i += NT) {
    const int r = i / nv, c = (i % nv) * kVec;
    const size_t g = (size_t)(r0 + r) * hd + c;
    if (vec_ok) {
      cp_async16(Ks + r * kRow + c, kb + g);
      cp_async16(Vs + r * kRow + c, vb + g);
    } else {
      for (int e = 0; e < kVec; ++e) {
        const bool ok = c + e < hd;
        Ks[r * kRow + c + e] = ok ? kb[g + e] : T(0.f);
        Vs[r * kRow + c + e] = ok ? vb[g + e] : T(0.f);
      }
    }
  }
  for (int i = nrows * kRow + threadIdx.x; i < zero_to * kRow; i += NT) {
    Ks[i] = T(0.f);
    Vs[i] = T(0.f);
  }
  cp_async_commit();
}

// A row's log-sum-exp of its scaled scores from its running max m and sum
// l; -inf for a row with no valid key (l == 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

// After a block wrote its partials (m, l, acc) for `nheads` query rows from
// row0: the last of the nsplit blocks of this (b, kv head, head chunk) to
// finish merges them into the output (threadFenceReduction's pattern: each
// block makes its writes visible before it counts itself) and resets the
// counter.  A warp per row: lanes over splits for the weights, then lanes
// over hd with the splits' rows loaded eight at a time.
template <typename T, int HD, int NW>
__device__ __forceinline__ void finish_splits(const float* part_ml, const float* part_acc,
                                              int* counter, T* out, float* lse,
                                              size_t row0, int nheads, int nsplit, int hd) {
  constexpr int EPL = HD / 32;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, d0 = lane * EPL;
  for (int g = warp; g < nheads; g += NW) {
    const size_t row = row0 + g;
    const float* ml = part_ml + row * nsplit * 2;
    const float* pa = part_acc + row * nsplit * hd;
    float mx = kNegInf;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    float lt = 0.f, at[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) at[e] = 0.f;
    for (int s0 = 0; s0 < nsplit; s0 += 32) {
      float w = 0.f, lw = 0.f;
      if (s0 + lane < nsplit) {
        w = expf(__ldcg(ml + 2 * (s0 + lane)) - mx);
        lw = __ldcg(ml + 2 * (s0 + lane) + 1) * w;
      }
      lt += warp_sum(lw);
      const int ns = min(32, nsplit - s0);
#pragma unroll 8
      for (int i = 0; i < ns; ++i) {
        const float wi = __shfl_sync(0xffffffffu, w, i);
        const float* src = pa + (size_t)(s0 + i) * hd + d0;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          if (d0 + e < hd) at[e] = fmaf(wi, __ldcg(src + e), at[e]);
      }
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (d0 + e < hd) store(out + row * hd + d0 + e, at[e] * inv);
    if (lse != nullptr && lane == 0) lse[row] = row_lse(mx, lt);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

// One block: (b, kv head) = blockIdx.x, key chunk blockIdx.y (keys
// [y * chunk, (y + 1) * chunk) below kv_len[b]), query heads
// [16 * blockIdx.z, ...) of the group, GP of them padded.
// q, out: (B, Hkv * G, hd); k, v: (B, Hkv, S, hd); part_ml: (B * Hq, nsplit,
// 2); part_acc: (B * Hq, nsplit, hd).
template <typename T, int HD, int GP>
__global__ void __launch_bounds__(Split<T, HD, GP>::NT)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ out, float* __restrict__ lse, float* part_ml, float* part_acc,
             int* __restrict__ counters, int Hkv, int G, int S, int hd,
             int chunk, int stages, float scale) {
  using L = Split<T, HD, GP>;
  constexpr int WH = L::WH, WK = L::WK, HPW = L::HPW, TK = L::TK, NW = L::NW, NT = L::NT;
  constexpr int EPL = HD / 32;                    // elements of d per lane
  constexpr int kRow = Layout<T, HD>::kRow;
  constexpr int kVec = Layout<T, HD>::kVec;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);              // [GP][HD]
  float* Ps = Qs + GP * HD;                                    // [NW][HPW][32]
  T* KV = reinterpret_cast<T*>(Ps + NW * HPW * 32);            // stages x (K, V) x [TK][kRow]

  const int bk = blockIdx.x, split = blockIdx.y, g0 = blockIdx.z * kMaxChunk;
  const int b = bk / Hkv, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wh = warp % WH, wk = warp / WH;
  const int n = min(max(kv_len[b], 0), S);
  const int c0 = split * chunk, c1 = min(c0 + chunk, n);
  const int Hq = Hkv * G;
  const size_t row0 = (size_t)b * Hq + (size_t)(bk % Hkv) * G + g0;  // first q row
  const T* kb = k + (size_t)bk * S * hd;
  const T* vb = v + (size_t)bk * S * hd;
  const bool vec_ok = hd % kVec == 0;

  for (int i = threadIdx.x; i < GP * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    Qs[i] = (g0 + g < G && d < hd) ? to_f32(q[(row0 + g) * hd + d]) : 0.f;
  }

  float m[HPW], l[HPW], acc[HPW][EPL];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }

  const int ntiles = c1 > c0 ? (c1 - c0 + TK - 1) / TK : 0;
  const size_t stage_elems = (size_t)2 * TK * kRow;
  if (ntiles > 0) load_tile<T, HD, NT>(KV, KV + TK * kRow, kb, vb, c0, min(TK, c1 - c0), hd, vec_ok);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = c0 + t * TK;
    T* Ks = KV + (t % stages) * stage_elems;
    T* Vs = Ks + TK * kRow;
    if (stages == 2 && t + 1 < ntiles) {  // the other buffer is free
      T* Kn = KV + ((t + 1) % 2) * stage_elems;
      load_tile<T, HD, NT>(Kn, Kn + TK * kRow, kb, vb, k0 + TK, min(TK, c1 - k0 - TK), hd, vec_ok);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int base = k0 + wk * 32;            // this warp's 32 keys
    const int nvalid = min(32, c1 - base);    // uniform across the warp
    if (nvalid > 0) {
      const T* krow = Ks + (wk * 32 + lane) * kRow;
      const T* vrow = Vs + wk * 32 * kRow + lane * EPL;
      float* pw = Ps + warp * HPW * 32;
      // scores: each K piece is loaded and converted once for all heads
      // (four partial sums a head, so no chain is longer than HD / 4 FMAs)
      float sc[HPW][4];
#pragma unroll
      for (int h = 0; h < HPW; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[h][e] = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += kVec) {
        float kx[kVec];
        load16(krow + c, kx);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          if (g0 + wh + WH * h >= G) break;   // padded heads; uniform
          const float* qg = Qs + (wh + WH * h) * HD + c;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qx = *reinterpret_cast<const float4*>(qg + e);
            sc[h][0] = fmaf(qx.x, kx[e], sc[h][0]);
            sc[h][1] = fmaf(qx.y, kx[e + 1], sc[h][1]);
            sc[h][2] = fmaf(qx.z, kx[e + 2], sc[h][2]);
            sc[h][3] = fmaf(qx.w, kx[e + 3], sc[h][3]);
          }
        }
      }
      // one max, one sum and one rescale per head and tile
      const bool ok = lane < nvalid;
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const float dot = (sc[h][0] + sc[h][1]) + (sc[h][2] + sc[h][3]);
        const float x = ok ? dot * scale : kNegInf;
        const float m_new = fmaxf(m[h], warp_max(x));
        const float corr = expf(m[h] - m_new);
        const float p = ok ? expf(x - m_new) : 0.f;
        l[h] = l[h] * corr + warp_sum(p);
        m[h] = m_new;
        pw[h * 32 + lane] = p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] *= corr;
      }
      __syncwarp();
      // P.V: each V row is loaded and converted once for all heads
#pragma unroll 4
      for (int j = 0; j < nvalid; ++j) {
        float vx[EPL];
        load_row<EPL>(vrow + j * kRow, vx);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const float pj = pw[h * 32 + j];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h][e] += pj * vx[e];
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the buffer is read; the next load may overwrite it
    if (stages == 1 && t + 1 < ntiles)
      load_tile<T, HD, NT>(KV, KV + TK * kRow, kb, vb, k0 + TK, min(TK, c1 - k0 - TK), hd, vec_ok);
  }

  const int d0 = lane * EPL;
  if constexpr (WK > 1) {
    // merge the WK warps that share a head (warp = wh + WH * wk) in shared
    // memory, reusing the K/V tiles
    float* Ms = reinterpret_cast<float*>(KV);           // [NW][HPW] m, l
    float* As = Ms + 2 * NW * HPW;                       // [NW][HPW][HD]
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      if (lane == 0) {
        Ms[2 * (warp * HPW + h)] = m[h];
        Ms[2 * (warp * HPW + h) + 1] = l[h];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) As[(warp * HPW + h) * HD + d0 + e] = acc[h][e];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < WK; ++w) mx = fmaxf(mx, Ms[2 * ((wh + WH * w) * HPW + h)]);
        float lt = 0.f, at[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) at[e] = 0.f;
#pragma unroll
        for (int w = 0; w < WK; ++w) {
          const int idx = (wh + WH * w) * HPW + h;
          const float c = expf(Ms[2 * idx] - mx);
          lt += Ms[2 * idx + 1] * c;
#pragma unroll
          for (int e = 0; e < EPL; ++e) at[e] += As[idx * HD + d0 + e] * c;
        }
        m[h] = mx;
        l[h] = lt;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] = at[e];
      }
    }
  }
  if (wk == 0) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = wh + WH * h;
      if (g0 + g >= G) break;
      const size_t row = row0 + g;
      if (nsplit == 1) {
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          if (d0 + e < hd) store(out + row * hd + d0 + e, acc[h][e] * inv);
        if (lse != nullptr && lane == 0) lse[row] = row_lse(m[h], l[h]);
      } else {
        const size_t ps = row * nsplit + split;
        if (lane == 0) {
          part_ml[2 * ps] = m[h];
          part_ml[2 * ps + 1] = l[h];
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          if (d0 + e < hd) part_acc[ps * hd + d0 + e] = acc[h][e];
      }
    }
  }
  if (nsplit > 1)
    finish_splits<T, HD, NW>(part_ml, part_acc, counters + (size_t)bk * gridDim.z + blockIdx.z,
                                 out, lse, row0, min(GP, G - g0), nsplit, hd);
}

// ---------------------------------------------------------------------------
// bf16, groups of 5 or more: tensor cores.  The chunk's query heads, padded
// to 16, are the 16 rows of mma.sync m16n8k16: S = Q K^T takes Q's fragments
// from registers (loaded once) and K's straight from the shared tile (two
// bf16 of a row per register, conflict-free with the 16-byte row padding);
// O += P V takes P from S's accumulators, rounded to bf16, and V by
// ldmatrix.trans.  Four warps take 16 keys each of a 64-key tile, keep their
// own (m, l, O) and merge them in shared memory at the end.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaTile = 16 * kMmaWarps;   // keys per tile

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int HD>
size_t mma_smem_bytes(int stages) {
  return (size_t)stages * 2 * kMmaTile * Layout<__nv_bfloat16, HD>::kRow * 2;
}

// Grid and partials as split_kernel's; hd == HD.
template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, float* part_ml,
           float* part_acc,
           int* __restrict__ counters, int Hkv, int G, int S, int chunk, int stages,
           float scale) {
  using T = __nv_bfloat16;
  constexpr int NT = 32 * kMmaWarps, TK = kMmaTile, kRow = Layout<T, HD>::kRow;
  constexpr int KS = HD / 16;    // 16-wide steps of hd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* KV = reinterpret_cast<T*>(smem_raw);          // stages x (K, V) x [TK][kRow]

  const int bk = blockIdx.x, split = blockIdx.y, g0 = blockIdx.z * kMaxChunk;
  const int b = bk / Hkv, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int n = min(max(kv_len[b], 0), S);
  const int c0 = split * chunk, c1 = min(c0 + chunk, n);
  const int Hq = Hkv * G, nheads = min(kMaxChunk, G - g0);
  const size_t row0 = (size_t)b * Hq + (size_t)(bk % Hkv) * G + g0;
  const T* kb = k + (size_t)bk * S * HD;
  const T* vb = v + (size_t)bk * S * HD;

  // Q's A fragments: rows gq and gq + 8 (heads), columns 16 ks + 2 tq (+1, +8, +9)
  uint32_t qa[KS][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + (row0 + gq) * HD);
    const uint32_t* q8 = reinterpret_cast<const uint32_t*>(q + (row0 + gq + 8) * HD);
    const bool ok0 = gq < nheads, ok8 = gq + 8 < nheads;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = ok0 ? q0[8 * ks + tq] : 0u;
      qa[ks][1] = ok8 ? q8[8 * ks + tq] : 0u;
      qa[ks][2] = ok0 ? q0[8 * ks + tq + 4] : 0u;
      qa[ks][3] = ok8 ? q8[8 * ks + tq + 4] : 0u;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // rows gq, gq + 8

  const int ntiles = c1 > c0 ? (c1 - c0 + TK - 1) / TK : 0;
  const size_t stage_elems = (size_t)2 * TK * kRow;
  if (ntiles > 0) load_tile<T, HD, NT>(KV, KV + TK * kRow, kb, vb, c0, min(TK, c1 - c0), HD, true, TK);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = c0 + t * TK;
    const T* Ks = KV + (t % stages) * stage_elems;
    const T* Vs = Ks + TK * kRow;
    if (stages == 2 && t + 1 < ntiles) {
      T* Kn = KV + ((t + 1) % 2) * stage_elems;
      load_tile<T, HD, NT>(Kn, Kn + TK * kRow, kb, vb, k0 + TK, min(TK, c1 - k0 - TK), HD, true, TK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int nvalid = min(16, c1 - (k0 + 16 * warp));   // this warp's keys; uniform
    if (nvalid > 0) {
      const T* kw = Ks + 16 * warp * kRow;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const T* kr = kw + (8 * nt + gq) * kRow + 16 * ks + 2 * tq;
          mma_bf16(sc[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      // sc[nt][c]: row gq (c < 2) or gq + 8, key 8 nt + 2 tq + (c & 1)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = 8 * nt + 2 * tq + (c & 1) < nvalid;
          sc[nt][c] = ok ? sc[nt][c] * scale : -INFINITY;
          if (c < 2) mx0 = fmaxf(mx0, sc[nt][c]); else mx1 = fmaxf(mx1, sc[nt][c]);
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float cr0 = expf(m0 - mn0), cr1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p[2][4], rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        p[nt][0] = expf(sc[nt][0] - mn0);
        p[nt][1] = expf(sc[nt][1] - mn0);
        p[nt][2] = expf(sc[nt][2] - mn1);
        p[nt][3] = expf(sc[nt][3] - mn1);
        rs0 += p[nt][0] + p[nt][1];
        rs1 += p[nt][2] + p[nt][3];
      }
      l0 = l0 * cr0 + rs0;
      l1 = l1 * cr1 + rs1;
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= cr0;
        o[j][1] *= cr0;
        o[j][2] *= cr1;
        o[j][3] *= cr1;
      }
      // V: matrices (keys 0-7 | 8-15) x (columns 16 nd + 0-7 | 8-15)
      const T* vw = Vs + (16 * warp + (lane & 8) + (lane & 7)) * kRow + ((lane >> 4) << 3);
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vw + 16 * nd);
        mma_bf16(o[2 * nd], pa, vb4[0], vb4[1]);
        mma_bf16(o[2 * nd + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();
    if (stages == 1 && t + 1 < ntiles)
      load_tile<T, HD, NT>(KV, KV + TK * kRow, kb, vb, k0 + TK, min(TK, c1 - k0 - TK), HD, true, TK);
  }
  cp_async_wait<0>();

  // merge the four warps' states in shared memory (reusing the tiles)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  float* Ml = reinterpret_cast<float*>(KV);            // [warp][16] m, then l
  float* As = Ml + 2 * kMmaWarps * 16;                 // [warp][16][HD]
  if (tq == 0) {
    Ml[warp * 16 + gq] = m0;
    Ml[warp * 16 + gq + 8] = m1;
    Ml[(kMmaWarps + warp) * 16 + gq] = l0;
    Ml[(kMmaWarps + warp) * 16 + gq + 8] = l1;
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float* a0 = As + (warp * 16 + gq) * HD + 8 * j + 2 * tq;
    a0[0] = o[j][0];
    a0[1] = o[j][1];
    a0[8 * HD] = o[j][2];
    a0[8 * HD + 1] = o[j][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nheads * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, Ml[w * 16 + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float c = expf(Ml[w * 16 + g] - mx);
      lt += Ml[(kMmaWarps + w) * 16 + g] * c;
      at += As[(w * 16 + g) * HD + d] * c;
    }
    const size_t row = row0 + g;
    if (nsplit == 1) {
      out[row * HD + d] = __float2bfloat16(at / fmaxf(lt, 1e-30f));
      if (lse != nullptr && d == 0) lse[row] = row_lse(mx, lt);
    } else {
      const size_t ps = row * nsplit + split;
      if (d == 0) {
        part_ml[2 * ps] = mx;
        part_ml[2 * ps + 1] = lt;
      }
      part_acc[ps * HD + d] = at;
    }
  }
  if (nsplit > 1)
    finish_splits<T, HD, kMmaWarps>(part_ml, part_acc,
                                    counters + (size_t)bk * gridDim.z + blockIdx.z, out, lse,
                                    row0, nheads, nsplit, HD);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kv_len,
                       void* out, float* lse, float* ws, int* counters, int B, int Hkv, int G, int S,
                       int nsplit, int chunk, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (chunk % kMmaTile != 0 || (size_t)chunk * nsplit < (size_t)S) return cudaErrorInvalidValue;
  const int stages = chunk > kMmaTile ? 2 : 1;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_smem_bytes<HD>(2));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int Hq = Hkv * G;
  float* part_ml = ws;
  float* part_acc = ws + (size_t)2 * B * Hq * nsplit;
  const dim3 grid(B * Hkv, nsplit, (G + kMaxChunk - 1) / kMaxChunk);
  mma_kernel<HD><<<grid, 32 * kMmaWarps, mma_smem_bytes<HD>(stages), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), lse, part_ml, part_acc, counters, Hkv,
      G, S, chunk, stages, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD, int GP>
size_t smem_bytes(int stages) {
  using L = Split<T, HD, GP>;
  constexpr int TK = L::TK;
  return sizeof(float) * (GP * HD + L::NW * L::HPW * 32) +
         (size_t)stages * 2 * TK * Layout<T, HD>::kRow * sizeof(T);
}

template <typename T, int HD, int GP>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, float* lse, float* ws, int* counters, int B,
                         int Hkv, int G, int S, int hd, int nsplit, int chunk,
                         cudaStream_t st) {
  constexpr int TK = Split<T, HD, GP>::TK;
  if (chunk % TK != 0 || (size_t)chunk * nsplit < (size_t)S) return cudaErrorInvalidValue;
  // two tiles in flight where a chunk has more than one and they fit
  const bool two_fit = smem_bytes<T, HD, GP>(2) <= kMaxSmem;
  const int stages = chunk > TK && two_fit ? 2 : 1;
  const size_t bytes = smem_bytes<T, HD, GP>(stages);
  static bool attr_set = false;  // set the limit once per instance
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, HD, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T, HD, GP>(two_fit ? 2 : 1));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int Hq = Hkv * G;
  float* part_ml = ws;
  float* part_acc = ws + (size_t)2 * B * Hq * nsplit;
  const dim3 grid(B * Hkv, nsplit, (G + kMaxChunk - 1) / kMaxChunk);
  split_kernel<T, HD, GP><<<grid, Split<T, HD, GP>::NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), lse, part_ml, part_acc,
      counters, Hkv, G, S, hd, chunk, stages, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, float* lse, float* ws, int* cnt, int B,
                         int Hkv, int G, int S, int hd, int nsplit, int chunk,
                         cudaStream_t st) {
#define DA_ARGS q, k, v, kv_len, out, lse, ws, cnt, B, Hkv, G, S, hd, nsplit, chunk, st
  if (G == 1) return launch_split<T, HD, 1>(DA_ARGS);
  if (G == 2) return launch_split<T, HD, 2>(DA_ARGS);
  if (G <= 4) return launch_split<T, HD, 4>(DA_ARGS);
  if (G <= 8) return launch_split<T, HD, 8>(DA_ARGS);
  return launch_split<T, HD, 16>(DA_ARGS);
#undef DA_ARGS
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, float* lse, float* ws, int* cnt, int B,
                         int Hkv, int G, int S, int hd, int nsplit, int chunk,
                         cudaStream_t st) {
  if (hd <= 32) return launch_group<T, 32>(q, k, v, kv_len, out, lse, ws, cnt, B, Hkv, G, S, hd, nsplit, chunk, st);
  if (hd <= 64) return launch_group<T, 64>(q, k, v, kv_len, out, lse, ws, cnt, B, Hkv, G, S, hd, nsplit, chunk, st);
  if (hd <= 128) return launch_group<T, 128>(q, k, v, kv_len, out, lse, ws, cnt, B, Hkv, G, S, hd, nsplit, chunk, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, Hq, hd); k, v: (B, Hkv, S, hd); kv_len: (B,) int32; all
// contiguous on the device.  lse, when not null: (B, Hq) f32, each row's
// log-sum-exp of its scaled scores (-inf for a row with no valid key), so
// that calls over disjoint key ranges merge.  The keys split into nsplit chunks of `chunk`
// keys, a multiple of the kernel's key tile (kernels/decode_attention/ops.py
// `_key_tile` computes it: 64 for the tensor-core kernel, bf16 with a group
// of 5 or more and hd 64 or 128; else Split<>::TK).  With nsplit > 1, ws is an
// f32 workspace of B * Hq * nsplit * (hd + 2) floats for the partials and
// counters B * Hkv * ceil(Hq / Hkv / 16) int32 zeros, left zero again.
// dtype 0 = float32, 1 = bfloat16.  One kernel launch; returns its
// cudaError_t (0 when it was accepted).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* lse, void* ws,
                                void* counters, int B, int Hq, int Hkv, int S,
                                int hd, int nsplit, int chunk, int dtype,
                                void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || hd <= 0 || Hq % Hkv != 0 || nsplit <= 0 ||
      nsplit > 65535 || (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) return launch_dtype<float>(q, k, v, kv_len, out, ls, w, c, B, Hkv, G, S, hd, nsplit, chunk, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (G >= 5 && hd == 64) return launch_mma<64>(q, k, v, kv_len, out, ls, w, c, B, Hkv, G, S, nsplit, chunk, st);
  if (G >= 5 && hd == 128) return launch_mma<128>(q, k, v, kv_len, out, ls, w, c, B, Hkv, G, S, nsplit, chunk, st);
  return launch_dtype<__nv_bfloat16>(q, k, v, kv_len, out, ls, w, c, B, Hkv, G, S, hd, nsplit, chunk, st);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
