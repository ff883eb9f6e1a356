// Backward of the Mamba selective scan for Hopper (sm_90a), over Bz rows of
// di channels.  The forward (csrc/ssm_scan.cu) is
//   h_t = da_t o h_{t-1} + dt_t u_t B_t,   da_t = exp(dt_t a),  a = -exp(A_log),
//   y_t = h_t . C_t + u_t D.
// With g_t = dL/dh_t = dy_t C_t + da_{t+1} o g_{t+1} (g_{S-1} also takes
// dh, the final state's gradient):
//   dC_t = sum_d h_t dy_t,  dB_t = sum_d g_t dt_t u_t        (over channels)
//   du_t = dt_t sum_s g_t B_t + dy_t D,
//   ddt_t = sum_s g_t (a da_t h_{t-1} + u_t B_t),
//   dA_log = sum_{b,t} g_t da_t h_{t-1} dt_t a,  dD = sum_{b,t} dy_t u_t,
//   dh0 = da_0 o g_0.
//
// No TPU counterpart: the Pallas kernel (src/repro/kernels/ssm_scan/kernel.py,
// ssm_scan at :61) is forward-only, and the JAX model differentiates its XLA
// scan (selective_scan_chunked, src/repro/models/ssm.py:81).
//
// What bounds it on this card: like the forward, the issue of its
// instructions more than its bytes.  It must read u, dt, dy and write du, ddt
// once per (row, step, channel) (16 bytes with u in bf16), ~270 MB at the
// training shape (Bz = 2, S = 512, di = 16384: 80 us at 3.35 TB/s); per
// (row, step, channel, state) it runs ~25 f32 operations and two exps
// (the recompute's and the walk's), about three times the forward's.
//
// What the design does about it:
//  * lanes as the forward's: d_state over DS / 4 lanes a channel, 4 states a
//    lane as a float4, a block CPB = 32 (DS 16) or 64 (DS 8) channels of one
//    row; a grid of (ceil(di / CPB), Bz) blocks;
//  * checkpoints: the forward, under grad mode, writes the state entering
//    each tile of kChunk = 16 steps (ssm_checkpoint.cuh; 16 bytes a lane,
//    coalesced).  The backward walks the tiles in reverse; for each it
//    reloads the entering state, recomputes the tile's 16 states into
//    registers (16 float4s a lane) with the forward's own arithmetic, and
//    walks them back.  It
//    never divides by da_t, which underflows to 0 where dt a is large;
//  * the tile's u, dt, dy (as f32, zero past S and past di, so a lane of a
//    channel past di adds nothing) and B, C go through shared memory, loaded
//    coalesced, one tile at a time;
//  * du and ddt sum over a channel's lanes by shuffles and leave through
//    shared memory, a whole tile's row of CPB channels at a time;
//  * dB and dC sum over channels: over a warp's channels by shuffles, over
//    the block's warps in warp order in shared memory, and each block writes
//    its partial sum (a row of gridDim.x partials per (row, step));
//    dA_log's and dD's sums over steps stay in registers and each row
//    writes its partial;
//  * ssm_bwd_reduce_kernel then adds the partials in a fixed order (block
//    by block for dB, dC; row by row for dA_log, dD): no atomics on data,
//    so the result is the same bits from call to call;
//  * bf16 u, B, C: all arithmetic in f32; du, dB, dC are written in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssm_checkpoint.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = kSsmCheckpoint;       // steps between checkpoints (the forward's kTile)
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x on the special-function unit, as the forward takes it
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float4 f4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// u: (Bz, S, di) of T; dt, dy: (Bz, S, di) f32; A_log: (di, DS) f32; Bm, Cm:
// (Bz, S, DS) of T; Dv: (di,) f32; ckpt: (Bz, nc, di, DS) f32, the state
// entering each tile of kChunk steps (nc = ceil(S / kChunk)); dh: (Bz, di,
// DS) f32.  Writes du (Bz, S, di) of T, ddt (Bz, S, di) f32, dh0 (Bz, di,
// DS) f32, and partial sums: part_bc (gridDim.x, Bz, S, 2 DS) f32 (dB then
// dC of the block's channels), part_a (Bz, di, DS) and part_d (Bz, di) f32
// (dA_log and dD of each row).  Grid (ceil(di / CPB), Bz).
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ ckpt, const float* __restrict__ dy,
               const float* __restrict__ dh, T* __restrict__ du, float* __restrict__ ddt,
               float* __restrict__ dh0, float* __restrict__ part_bc,
               float* __restrict__ part_a, float* __restrict__ part_d, int S, int di) {
  constexpr int LPC = DS / 4;                // lanes a channel
  constexpr int CPB = kThreads / LPC;        // channels a block
  __shared__ __align__(16) float s_u[kChunk][CPB];
  __shared__ __align__(16) float s_dt[kChunk][CPB];
  __shared__ __align__(16) float s_dy[kChunk][CPB];
  __shared__ __align__(16) float s_b[kChunk][DS];
  __shared__ __align__(16) float s_c[kChunk][DS];
  __shared__ float s_du[kChunk][CPB];
  __shared__ float s_ddt[kChunk][CPB];
  __shared__ __align__(16) float s_red[kWarps][kChunk][2 * DS];

  const int q = threadIdx.x % LPC, cl = threadIdx.x / LPC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * CPB;
  const int d = c0 + cl;
  const bool ok = d < di;
  const int dc = min(d, di - 1);
  const int b = blockIdx.y, Bz = gridDim.y;
  const size_t row = (size_t)b * S;                // index of (b, t = 0)
  const size_t hs = ((size_t)b * di + dc) * DS + 4 * q;
  const int nc = (S + kChunk - 1) / kChunk;

  float4 a = f4(A_log + (size_t)dc * DS + 4 * q);
  a = make_float4(-expf(a.x), -expf(a.y), -expf(a.z), -expf(a.w));
  const float4 a2 = make_float4(a.x * kLog2e, a.y * kLog2e, a.z * kLog2e, a.w * kLog2e);
  const float dd = Dv[dc];
  float4 g = dh != nullptr ? f4(dh + hs) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dA = make_float4(0.f, 0.f, 0.f, 0.f);
  float dD = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, tn = min(kChunk, S - t0);
    __syncthreads();                         // the last tile's shared memory is read
    for (int idx = threadIdx.x; idx < kChunk * CPB; idx += kThreads) {
      const int t = idx / CPB, ch = idx % CPB;
      const bool live = t < tn && c0 + ch < di;
      const size_t at = (row + t0 + t) * di + c0 + ch;
      s_u[t][ch] = live ? to_f32(u[at]) : 0.f;
      s_dt[t][ch] = live ? dt[at] : 0.f;
      s_dy[t][ch] = live ? dy[at] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kChunk * DS; idx += kThreads) {
      const int t = idx / DS, s = idx % DS;
      const bool live = t < tn;
      s_b[t][s] = live ? to_f32(Bm[(row + t0 + t) * DS + s]) : 0.f;
      s_c[t][s] = live ? to_f32(Cm[(row + t0 + t) * DS + s]) : 0.f;
    }
    __syncthreads();

    // the tile's states from its checkpoint, as the forward computes them
    const float4 h_in = f4(ckpt + (((size_t)b * nc + c) * di + dc) * DS + 4 * q);
    float4 hh[kChunk];
    {
      float4 h = h_in;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float dtt = s_dt[t][cl], dbu = dtt * s_u[t][cl];
        const float4 bb = f4(&s_b[t][4 * q]);
        h.x = fmaf(exp2_approx(dtt * a2.x), h.x, dbu * bb.x);
        h.y = fmaf(exp2_approx(dtt * a2.y), h.y, dbu * bb.y);
        h.z = fmaf(exp2_approx(dtt * a2.z), h.z, dbu * bb.z);
        h.w = fmaf(exp2_approx(dtt * a2.w), h.w, dbu * bb.w);
        hh[t] = h;
      }
    }

    // the walk back over the tile's steps (steps past S: skipped, uniform
    // over the block)
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      if (t >= tn) continue;
      const float dyt = s_dy[t][cl], ut = s_u[t][cl], dtt = s_dt[t][cl];
      const float4 bb = f4(&s_b[t][4 * q]), cc = f4(&s_c[t][4 * q]);
      const float4 hp = t > 0 ? hh[t > 0 ? t - 1 : 0] : h_in;
      g.x = fmaf(dyt, cc.x, g.x);
      g.y = fmaf(dyt, cc.y, g.y);
      g.z = fmaf(dyt, cc.z, g.z);
      g.w = fmaf(dyt, cc.w, g.w);
      const float4 da = make_float4(exp2_approx(dtt * a2.x), exp2_approx(dtt * a2.y),
                                    exp2_approx(dtt * a2.z), exp2_approx(dtt * a2.w));
      const float4 gdh = make_float4(g.x * da.x * hp.x, g.y * da.y * hp.y, g.z * da.z * hp.z,
                                     g.w * da.w * hp.w);
      float gb = fmaf(g.x, bb.x, g.y * bb.y) + fmaf(g.z, bb.z, g.w * bb.w);
      float ga = fmaf(gdh.x, a.x, gdh.y * a.y) + fmaf(gdh.z, a.z, gdh.w * a.w);
#pragma unroll
      for (int o = LPC / 2; o > 0; o >>= 1) {
        gb += __shfl_xor_sync(0xffffffffu, gb, o);
        ga += __shfl_xor_sync(0xffffffffu, ga, o);
      }
      if (q == 0) {
        s_du[t][cl] = fmaf(dtt, gb, dyt * dd);
        s_ddt[t][cl] = fmaf(ut, gb, ga);
      }
      dA.x = fmaf(gdh.x, dtt, dA.x);
      dA.y = fmaf(gdh.y, dtt, dA.y);
      dA.z = fmaf(gdh.z, dtt, dA.z);
      dA.w = fmaf(gdh.w, dtt, dA.w);
      dD = fmaf(dyt, ut, dD);
      // dB, dC: this lane's 4 states, summed over the warp's channels
      const float dbu = dtt * ut;
      float p[8] = {g.x * dbu, g.y * dbu, g.z * dbu, g.w * dbu,
                    hh[t].x * dyt, hh[t].y * dyt, hh[t].z * dyt, hh[t].w * dyt};
#pragma unroll
      for (int o = LPC; o < 32; o <<= 1)
#pragma unroll
        for (int m = 0; m < 8; ++m) p[m] += __shfl_xor_sync(0xffffffffu, p[m], o);
      if (lane < LPC) {
        *reinterpret_cast<float4*>(&s_red[warp][t][4 * q]) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&s_red[warp][t][DS + 4 * q]) =
            make_float4(p[4], p[5], p[6], p[7]);
      }
      g = make_float4(da.x * g.x, da.y * g.y, da.z * g.z, da.w * g.w);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < tn * CPB; idx += kThreads) {
      const int t = idx / CPB, ch = idx % CPB;
      if (c0 + ch < di) {
        const size_t at = (row + t0 + t) * di + c0 + ch;
        du[at] = from_f32<T>(s_du[t][ch]);
        ddt[at] = s_ddt[t][ch];
      }
    }
    for (int idx = threadIdx.x; idx < tn * 2 * DS; idx += kThreads) {
      const int t = idx / (2 * DS), e = idx % (2 * DS);
      float sum = s_red[0][t][e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += s_red[w][t][e];
      part_bc[(((size_t)blockIdx.x * Bz + b) * S + t0 + t) * 2 * DS + e] = sum;
    }
  }

  if (ok) {
    *reinterpret_cast<float4*>(dh0 + hs) = g;
    *reinterpret_cast<float4*>(part_a + hs) =
        make_float4(dA.x * a.x, dA.y * a.y, dA.z * a.z, dA.w * a.w);
    if (q == 0) part_d[(size_t)b * di + d] = dD;
  }
}

// The fixed-order sums of the partials: dB, dC (Bz, S, DS) of T over the gx
// blocks of channels, block 0 first; dA_log (di, DS) and dD (di,) f32 over
// the Bz rows, row 0 first.  One thread an output element.
template <typename T, int DS>
__global__ void __launch_bounds__(256)
ssm_bwd_reduce_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                      const float* __restrict__ part_d, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA_log, float* __restrict__ dD, int Bz, int S,
                      int di, int gx) {
  const size_t n_bc = (size_t)Bz * S * 2 * DS, n_a = (size_t)di * DS;
  const size_t total = n_bc + n_a + di;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      float sum = 0.f;
      for (int x = 0; x < gx; ++x) sum += part_bc[(size_t)x * n_bc + i];
      const size_t bt = i / (2 * DS);
      const int e = (int)(i % (2 * DS));
      if (e < DS)
        dB[bt * DS + e] = from_f32<T>(sum);
      else
        dC[bt * DS + e - DS] = from_f32<T>(sum);
    } else if (i < n_bc + n_a) {
      const size_t e = i - n_bc;
      float sum = 0.f;
      for (int b = 0; b < Bz; ++b) sum += part_a[(size_t)b * n_a + e];
      dA_log[e] = sum;
    } else {
      const size_t e = i - n_bc - n_a;
      float sum = 0.f;
      for (int b = 0; b < Bz; ++b) sum += part_d[(size_t)b * di + e];
      dD[e] = sum;
    }
  }
}

template <typename T, int DS>
cudaError_t launch(const void* u, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, const void* Dv, const void* ckpt, const void* dy,
                   const void* dh, void* du, void* ddt, void* dA_log, void* dB, void* dC,
                   void* dD, void* dh0, void* part_bc, void* part_a, void* part_d, int Bz,
                   int S, int di, cudaStream_t stream) {
  constexpr int CPB = kThreads / (DS / 4);
  const int gx = (di + CPB - 1) / CPB;
  ssm_bwd_kernel<T, DS><<<dim3(gx, Bz), kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(Dv), static_cast<const float*>(ckpt),
      static_cast<const float*>(dy), static_cast<const float*>(dh), static_cast<T*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dh0), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), static_cast<float*>(part_d), S, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)Bz * S * 2 * DS + (size_t)di * DS + di;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  ssm_bwd_reduce_kernel<T, DS><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA_log), static_cast<float*>(dD), Bz, S, di, gx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* u, const void* dt, const void* A_log, const void* Bm,
                      const void* Cm, const void* Dv, const void* ckpt, const void* dy,
                      const void* dh, void* du, void* ddt, void* dA_log, void* dB, void* dC,
                      void* dD, void* dh0, void* part_bc, void* part_a, void* part_d, int Bz,
                      int S, int di, int ds, cudaStream_t st) {
  if (ds == 8)
    return launch<T, 8>(u, dt, A_log, Bm, Cm, Dv, ckpt, dy, dh, du, ddt, dA_log, dB, dC, dD,
                        dh0, part_bc, part_a, part_d, Bz, S, di, st);
  if (ds == 16)
    return launch<T, 16>(u, dt, A_log, Bm, Cm, Dv, ckpt, dy, dh, du, ddt, dA_log, dB, dC, dD,
                         dh0, part_bc, part_a, part_d, Bz, S, di, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// u, B, C: dtype 0 = float32, 1 = bfloat16, as the forward took them; dt,
// A_log, D: as the forward; ckpt: (Bz, ceil(S / kChunk), di, ds) f32, the
// forward's checkpoints, and ckpt_steps the caller's interval between them
// (it must be kChunk); dy: (Bz, S, di) f32; dh: (Bz, di, ds) f32 or null
// (zero).  Writes du (u's dtype), ddt, dA_log, dB, dC (B's dtype), dD, dh0
// in the shapes of the forward's inputs, using the f32 scratch part_bc
// (ceil(di / (128 / (ds / 4))), Bz, S, 2 ds), part_a (Bz, di, ds) and
// part_d (Bz, di).  All contiguous, 16-byte aligned, on the device; two
// launches on `stream`.  Returns the first launch error (0 when both were
// accepted).
extern "C" int ssm_scan_bwd(const void* u, const void* dt, const void* A_log, const void* B,
                            const void* C, const void* D, const void* ckpt, const void* dy,
                            const void* dh, void* du, void* ddt, void* dA_log, void* dB,
                            void* dC, void* dD, void* dh0, void* part_bc, void* part_a,
                            void* part_d, int Bz, int S, int di, int ds, int dtype,
                            int ckpt_steps, void* stream) {
  if (Bz <= 0 || Bz > 65535 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  if (ckpt_steps != kChunk) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ds<float>(u, dt, A_log, B, C, D, ckpt, dy, dh, du, ddt, dA_log, dB, dC, dD,
                            dh0, part_bc, part_a, part_d, Bz, S, di, ds, st);
  if (dtype == 1)
    return launch_ds<__nv_bfloat16>(u, dt, A_log, B, C, D, ckpt, dy, dh, du, ddt, dA_log, dB,
                                    dC, dD, dh0, part_bc, part_a, part_d, Bz, S, di, ds, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
