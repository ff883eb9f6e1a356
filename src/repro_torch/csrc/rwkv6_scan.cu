// RWKV-6 WKV recurrence for Hopper (sm_90a), over N = batch * heads rows:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// with w_t = exp(logw_t) and a carried (hd x hd) f32 state per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (_wkv_kernel at :23, launched by rwkv6_scan at :73).  That kernel walks a
// sequential grid axis of chunks with the state in VMEM scratch and computes
// each chunk in closed form on the matrix unit.  Here the sequential form of
// the same recurrence runs inside one block: blocks on this card run in no
// order, so nothing is carried from one block to another.
//
// What bounds it on this card: in principle bytes.  It reads r, k, v, logw
// once and writes y once (4 * S * hd elements a row) and does 4 * hd FLOPs per
// element (the read-out and the update, one multiply-add each per state
// element): 16 FLOPs per f32 element read, under the ~20 FLOPs per byte the
// card needs (67 TFLOP/s f32 over 3.35 TB/s) before compute binds.  In
// practice, at the main path's shape (N = 32 rows, S <= 256, hd = 64), the
// time steps are a chain of dependent updates and the grid is small, so this
// first version is bound by latency, far from both.
//
// What the design does about it:
//  * state column j of a row is independent of every other column (y_t[j]
//    and S_t[:, j] read only S_{t-1}[:, j]), so a block takes one row and 32
//    value columns (one per lane), and the grid is N x ceil(hd / 32) blocks;
//  * the key axis i is split over the block's warps, kRows state rows each, so
//    each thread keeps a kRows x 1 slice of the state in registers and the
//    dependent chain per step is kRows long, not hd; each warp's partial
//    read-out goes to shared memory, and the block sums the partials once per
//    tile of kTile steps (the only cross-warp step: the state update needs
//    none);
//  * a tile of r, k and w = exp(logw) for all hd channels and kTile steps is
//    staged in shared memory with coalesced loads; lanes read the same
//    address there (a broadcast), and y is stored one coalesced 32-column row
//    per step;
//  * all arithmetic is in f32; w <= 1, so nothing grows without bound
//    whatever S is.
// Known limits: no overlap of the next tile's loads with this tile's steps,
// and 2 x 32 blocks on the main path against the card's 132 SMs.  The
// chunked form on tensor cores (the TPU kernel's), or a finer split of the
// key axis, is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;                    // state rows per thread (key axis)
constexpr int kCols = 32;                    // value columns per block (lanes)
constexpr int kMaxHd = 128;
constexpr int kMaxWarps = kMaxHd / kRows;    // 8
constexpr int kTile = 16;                    // time steps staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// r, k, v: (N, S, hd) of T; logw, out: (N, S, hd) f32; u: (N, hd) f32;
// state0, state_out: (N, hd, hd) f32; all contiguous.  Block (n, column
// slice); blockDim.x = 32 * ceil(hd / kRows).
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ state0,
           float* __restrict__ out, float* __restrict__ state_out, int S,
           int hd) {
  // rows [hd, hd_pad) are staged as r = k = w = 0, so their state stays 0
  __shared__ __align__(16) float s_r[kTile][kMaxHd];
  __shared__ __align__(16) float s_k[kTile][kMaxHd];
  __shared__ __align__(16) float s_w[kTile][kMaxHd];
  __shared__ float s_v[kTile][kCols];
  __shared__ float s_y[kMaxWarps][kTile][kCols];

  const int n = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int hd_pad = nwarps * kRows;
  const int j = c0 + lane;                   // this thread's value column
  const bool col_ok = j < hd;
  const int i0 = warp * kRows;               // this thread's first state row

  const size_t seq = (size_t)n * S * hd;
  const T* rn = r + seq;
  const T* kn = k + seq;
  const T* vn = v + seq;
  const float* wn = logw + seq;
  float* on = out + seq;
  const size_t mat = (size_t)n * hd * hd;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int i = i0 + e;
    st[e] = (i < hd && col_ok) ? state0[mat + (size_t)i * hd + j] : 0.f;
    uu[e] = i < hd ? u[(size_t)n * hd + i] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tn = min(kTile, S - t0);
    __syncthreads();   // the previous tile's reads of s_* are done
    for (int idx = threadIdx.x; idx < tn * hd_pad; idx += blockDim.x) {
      const int t = idx / hd_pad, i = idx % hd_pad;
      const bool ok = i < hd;
      const size_t g = (size_t)(t0 + t) * hd + i;
      s_r[t][i] = ok ? to_f32(rn[g]) : 0.f;
      s_k[t][i] = ok ? to_f32(kn[g]) : 0.f;
      s_w[t][i] = ok ? expf(wn[g]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < tn * kCols; idx += blockDim.x) {
      const int t = idx / kCols, c = idx % kCols;
      s_v[t][c] = c0 + c < hd ? to_f32(vn[(size_t)(t0 + t) * hd + c0 + c]) : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < tn; ++t) {
      const float vj = s_v[t][lane];
      const float4* r4 = reinterpret_cast<const float4*>(&s_r[t][i0]);
      const float4* k4 = reinterpret_cast<const float4*>(&s_k[t][i0]);
      const float4* w4 = reinterpret_cast<const float4*>(&s_w[t][i0]);
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x * vj, kk.y * vj, kk.z * vj, kk.w * vj};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = 4 * q + m;
          const float term = rv[m] * fmaf(uu[e], kv[m], st[e]);
          if (m % 2) yb += term; else ya += term;
          st[e] = fmaf(wv[m], st[e], kv[m]);
        }
      }
      s_y[warp][t][lane] = ya + yb;
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < tn * kCols; idx += blockDim.x) {
      const int t = idx / kCols, c = idx % kCols;
      if (c0 + c >= hd) continue;
      float y = 0.f;
      for (int w = 0; w < nwarps; ++w) y += s_y[w][t][c];
      on[(size_t)(t0 + t) * hd + c0 + c] = y;
    }
  }

#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int i = i0 + e;
    if (i < hd && col_ok) state_out[mat + (size_t)i * hd + j] = st[e];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* state0,
                   void* out, void* state_out, int N, int S, int hd,
                   cudaStream_t stream) {
  const dim3 grid(N, (hd + kCols - 1) / kCols);
  const dim3 block(32 * ((hd + kRows - 1) / kRows));
  wkv_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(out), static_cast<float*>(state_out), S, hd);
  return cudaGetLastError();
}

}  // namespace

// r, k, v: (N, S, hd), dtype 0 = float32, 1 = bfloat16; logw: (N, S, hd)
// f32; u: (N, hd) f32; state0: (N, hd, hd) f32; out: (N, S, hd) f32;
// state_out: (N, hd, hd) f32; all contiguous on the device.  Returns the
// launch's cudaError_t (0 when it was accepted).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* state0,
                          void* out, void* state_out, int N, int S, int hd,
                          int dtype, void* stream) {
  if (N <= 0 || S <= 0 || hd <= 0 || hd > kMaxHd) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, state0, out, state_out, N, S, hd, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, state0, out, state_out, N, S, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
