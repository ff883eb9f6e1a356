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
// causal, f32) that is 5.4 GFLOP on 17 MB: the CUDA cores' FMA rate binds
// (80 µs at 67 TFLOP/s against 5 µs for the bytes).
//
// This first version is simple and right, on the CUDA cores, f32
// accumulation whatever the input type (f32 or bf16); tensor cores are later
// work.  Three launches:
//
//  * dot_kernel: D, one warp per row;
//  * dkdv_kernel: one block of 256 threads per (b, KV head, 64 keys).  K and
//    V stay in shared memory; the block walks the query tiles of every query
//    head of the group that can see its keys (from the first query whose
//    position reaches the block's first key), and each thread accumulates a
//    4 x (hd / 16) tile of dK and of dV in registers;
//  * dq_kernel: one block per (b, h, 64 queries) over the key tiles the
//    forward visits, dQ in registers.  S and dP are computed a second time
//    there instead of adding dQ across key blocks with atomics, so the
//    result does not depend on the order blocks run in.
//
// Tiles live in shared memory as f32 rows of hd + 4 (HD = 64 or 128 built);
// each thread owns a 4 x 4 tile of S and dP (query rows 4 ty + i, key
// columns tx + 16 j), as in the forward's CUDA-core kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // queries or keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty = query / key group, tx = column group
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float pick(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

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

// D[row] = sum_d dO[row, d] O[row, d]; one warp per row of B * Hq * Sq.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
           int rows, int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + (size_t)row * hd;
  const T* b = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(a[d]) * to_f32(b[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// One block: keys [k0, k0 + 64) of KV head (b, hk) = blockIdx.y, k0 =
// 64 blockIdx.x.  Thread (ty, tx) accumulates dK and dV of keys 4 ty + i,
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

  const int kvbh = blockIdx.y, b = kvbh / Hkv, hk = kvbh % Hkv, group = Hq / Hkv;
  const int k0 = blockIdx.x * kTile;
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

// One block: queries [q0, q0 + 64) of (b, h) = blockIdx.y (tiles from the
// last, so the longest causal blocks start first).  Thread (ty, tx)
// accumulates dQ of queries 4 ty + i, columns 4 tx + 64 c + e.
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

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Sk, int hd, int causal, int q_offset, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  // the opt-in above 48 KB belongs to the current device: set it every call
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)hd);
  const int rows = B * Hq * Sq;
  dot_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<T, HD><<<dim3((Sk + kTile - 1) / kTile, B * Hkv), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
      Sq, Sk, hd, causal, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3((Sq + kTile - 1) / kTile, B * Hq), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, hd, causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
                      int q_offset, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd, causal,
                         q_offset, st);
  return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd, causal,
                        q_offset, st);
}

}  // namespace

// q, o, dout, dq: (B, Hq, Sq, hd); k, v, dk, dv: (B, Hkv, Sk, hd); lse and
// delta (scratch for D): (B, Hq, Sq) f32; all contiguous on the device.
// dtype 0 = float32, 1 = bfloat16.  Returns the first launch error
// (cudaError_t, 0 when all three launches were accepted).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int hd, int causal, int q_offset, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd > 128 || Hq % Hkv != 0 ||
      B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd,
                            causal, q_offset, st);
  if (dtype == 1)
    return launch_hd<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd,
                           causal, q_offset, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
