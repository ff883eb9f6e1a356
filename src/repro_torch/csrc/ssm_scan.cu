// Mamba selective scan for Hopper (sm_90a), over Bz rows of di channels:
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * u_t * B_t,   a = -exp(A_log),
//   y_t = h_t . C_t + u_t * D,
// with a (di x ds) f32 state per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssm_kernel at :24, launched by ssm_scan at :61, pallas_call at :80).
// That kernel walks a sequential grid axis of chunks with the (block_di x
// ds) state in VMEM scratch and evaluates each chunk with an associative
// scan.  Here the sequential form of the same recurrence runs in one thread
// per (row, channel): channel d's state depends on no other channel, and
// blocks on this card run in no order, so nothing is carried between them.
//
// What bounds it on this card: it reads u, dt once and writes y once per
// (row, step, channel) (10 bytes with u in bf16, 12 in f32), plus the small
// B, C, A, D and the state; at the main path's prefill (Bz = 1, di = 16384,
// S = 256) that is ~45 MB, 13 us at 3.35 TB/s.  Its arithmetic is ~7 f32
// operations and one exp per (row, step, channel, state): 7 us at the f32
// peak of 67 TFLOP/s, but the exps run on the special-function units at 16
// per SM per clock, about 19 us at this shape.  And the steps are a chain of
// dependent updates over only di = 16384 threads (one warp per scheduler),
// so latency is the first limit of this version.
//
// What the design does about it:
//  * one thread per (row, channel); the ds values of h and of a = -exp(A)
//    (pre-scaled by log2 e, so each step's exp is one ex2 instruction) live
//    in registers, with ds a template parameter (8 or 16) so they stay there;
//  * the ds state updates of a step are independent (ILP ds), and y sums
//    them in two chains;
//  * B_t and C_t of a tile of kTile steps are staged in shared memory as f32
//    and read by every thread of the block (one address: a broadcast);
//  * u, dt, B and C of the tile are loaded into registers before the tile's
//    steps, from clamped indices without a branch, so they are all in flight
//    at once; u, dt and y are coalesced along the channel axis;
//  * all arithmetic is in f32, as in the reference.
// Known limits: one exp per state element per step (the SFU rate), and no
// overlap of the next tile's loads with this tile's steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                // channels per block
constexpr int kTile = 16;                    // time steps staged per pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x on the special-function unit, results below 2^-126 flushed to 0 (the
// decay factors are <= 1; a flushed one contributes nothing at f32)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// u: (Bz, S, di) of T; dt: (Bz, S, di) f32; A_log: (di, DS) f32; Bm, Cm:
// (Bz, S, DS) of T; Dv: (di,) f32; h0, h_out: (Bz, di, DS) f32; y: (Bz, S,
// di) f32; all contiguous.  Grid (ceil(di / kThreads), Bz).
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_kernel(const T* __restrict__ u, const float* __restrict__ dt,
           const float* __restrict__ A_log, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           const float* __restrict__ h0, float* __restrict__ y,
           float* __restrict__ h_out, int S, int di) {
  constexpr int kPer = (kTile * DS + kThreads - 1) / kThreads;  // B, C per thread
  __shared__ float s_b[kTile][DS];
  __shared__ float s_c[kTile][DS];

  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = d < di;
  // loads use a clamped channel and step and need no branch, so each batch
  // of them is in flight at once (a guarded load followed by its use stalls
  // on every load); only the stores are guarded
  const int dc = min(d, di - 1);
  const size_t row = (size_t)blockIdx.y * S;      // index of (b, t = 0)
  const size_t hs = ((size_t)blockIdx.y * di + dc) * DS;

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = A_log[(size_t)dc * DS + s];
    h[s] = h0[hs + s];
  }
  const float dd = Dv[dc];
#pragma unroll
  for (int s = 0; s < DS; ++s) a[s] = -expf(a[s]) * kLog2e;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tn = min(kTile, S - t0);
    T bv[kPer], cv[kPer], uu[kTile];
    float tt[kTile];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const size_t g = (row + t0) * DS + min((int)threadIdx.x + j * kThreads, tn * DS - 1);
      bv[j] = Bm[g];
      cv[j] = Cm[g];
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const size_t g = (row + t0 + min(t, tn - 1)) * di + dc;
      uu[t] = u[g];
      tt[t] = dt[g];
    }
    __syncthreads();   // the previous tile's reads of s_b, s_c are done
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = (int)threadIdx.x + j * kThreads;
      if (i < tn * DS) {
        s_b[i / DS][i % DS] = to_f32(bv[j]);
        s_c[i / DS][i % DS] = to_f32(cv[j]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (t < tn) {
        const float ut = to_f32(uu[t]);
        const float dbu = tt[t] * ut;
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = fmaf(exp2_approx(tt[t] * a[s]), h[s], dbu * s_b[t][s]);
          if (s % 2) y1 = fmaf(h[s], s_c[t][s], y1);
          else y0 = fmaf(h[s], s_c[t][s], y0);
        }
        if (ok) y[(row + t0 + t) * di + d] = fmaf(ut, dd, y0 + y1);
      }
    }
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_out[hs + s] = h[s];
  }
}

template <typename T, int DS>
cudaError_t launch(const void* u, const void* dt, const void* A_log,
                   const void* Bm, const void* Cm, const void* Dv,
                   const void* h0, void* y, void* h_out, int Bz, int S,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, Bz);
  ssm_kernel<T, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* u, const void* dt, const void* A_log,
                      const void* Bm, const void* Cm, const void* Dv,
                      const void* h0, void* y, void* h_out, int Bz, int S,
                      int di, int ds, cudaStream_t stream) {
  if (ds == 8)
    return launch<T, 8>(u, dt, A_log, Bm, Cm, Dv, h0, y, h_out, Bz, S, di, stream);
  if (ds == 16)
    return launch<T, 16>(u, dt, A_log, Bm, Cm, Dv, h0, y, h_out, Bz, S, di, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// u, B, C: dtype 0 = float32, 1 = bfloat16; u: (Bz, S, di); B, C: (Bz, S,
// ds); dt: (Bz, S, di) f32; A_log: (di, ds) f32; D: (di,) f32; h0, h_out:
// (Bz, di, ds) f32; y: (Bz, S, di) f32; ds 8 or 16; all contiguous on the
// device.  Returns the launch's cudaError_t (0 when it was accepted).
extern "C" int ssm_scan(const void* u, const void* dt, const void* A_log,
                        const void* B, const void* C, const void* D,
                        const void* h0, void* y, void* h_out, int Bz, int S,
                        int di, int ds, int dtype, void* stream) {
  if (Bz <= 0 || Bz > 65535 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ds<float>(u, dt, A_log, B, C, D, h0, y, h_out, Bz, S, di, ds, st);
  if (dtype == 1)
    return launch_ds<__nv_bfloat16>(u, dt, A_log, B, C, D, h0, y, h_out, Bz, S, di, ds, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
