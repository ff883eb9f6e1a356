// What the WKV scan's kernels share, forward (rwkv6_scan.cu) and backward
// (rwkv6_scan_bwd.cu): a block of kThreads threads takes one chunk of C
// steps of one row, with hd padded to HDP (64 or 128) in shared memory;
// rows of a chunk are staged by Rows (16-byte loads, zeros past S and past
// hd), and the cumulative log-decays are taken in log2 units by
// cumsum_columns, so each exponential is one ex2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;       // steps a chunk, C below
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x on the special-function unit; x <= 0 here, results below 2^-126
// flushed to 0 (a decay that small contributes nothing at f32)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 16 bytes of src as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void load16(const float* src, float* x) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* x) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float2 f = __bfloat1622float2(h[m]);
    x[2 * m] = f.x;
    x[2 * m + 1] = f.y;
  }
}

template <int HDP, int C>
struct Shape {
  static constexpr int LD = HDP + 4;   // smem row stride: float4 rows, no bank conflicts
  static constexpr int TILE = C * LD;  // one staged (C x HDP) array
};

// One thread's share of a (C x HDP) chunk of rows of hd (tn of them valid),
// loaded before it is stored so that all of a block's loads are in flight
// at once: 16 bytes of T a load where `vec` (hd a multiple of 16 bytes of T,
// src 16-byte aligned), zeros past tn and past hd.
template <typename T, int HDP, int C>
struct Rows {
  static constexpr int G = 16 / sizeof(T), GPR = HDP / G;
  static constexpr int IT = (C * GPR + kThreads - 1) / kThreads;
  float x[IT][G];

  __device__ __forceinline__ void load(const T* __restrict__ src, int tn, int hd, bool vec) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int t = idx / GPR, c0 = (idx % GPR) * G;
      if (vec && t < tn && c0 + G <= hd) {
        load16(src + (size_t)t * hd + c0, x[it]);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e)
          x[it][e] = (idx < C * GPR && t < tn && c0 + e < hd)
                         ? to_f32(src[(size_t)t * hd + c0 + e]) : 0.f;
      }
    }
  }

  // into dst (C x LD floats), times `scale`
  __device__ __forceinline__ void store(float* dst, float scale) const {
    constexpr int LD = Shape<HDP, C>::LD;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (idx >= C * GPR) break;
      const int t = idx / GPR, c0 = (idx % GPR) * G;
#pragma unroll
      for (int q = 0; q < G / 4; ++q)
        *reinterpret_cast<float4*>(dst + t * LD + c0 + 4 * q) =
            make_float4(scale * x[it][4 * q], scale * x[it][4 * q + 1],
                        scale * x[it][4 * q + 2], scale * x[it][4 * q + 3]);
    }
  }
};

// In place: each column of cum (C x LD) becomes its inclusive cumulative
// sum, C lanes a column (a scan by shuffles), all columns at once.
template <int HDP, int C>
__device__ __forceinline__ void cumsum_columns(float* cum) {
  constexpr int LD = Shape<HDP, C>::LD, CPW = 32 / C, NW = kThreads / 32;
  const int lane = threadIdx.x % 32, t = lane % C;
  static_assert(HDP % (NW * CPW) == 0, "columns do not share out over the warps");
#pragma unroll
  for (int ch0 = 0; ch0 < HDP; ch0 += NW * CPW) {
    const int ch = ch0 + (threadIdx.x / 32) * CPW + lane / C;
    float x = cum[t * LD + ch];
#pragma unroll
    for (int o = 1; o < C; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o, C);
      if (t >= o) x += y;
    }
    cum[t * LD + ch] = x;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

}  // namespace
