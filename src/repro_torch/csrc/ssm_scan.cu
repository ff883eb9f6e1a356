// Mamba selective scan for Hopper (sm_90a), over Bz rows of di channels:
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * u_t * B_t,   a = -exp(A_log),
//   y_t = h_t . C_t + u_t * D,
// with a (di x ds) f32 state per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssm_kernel at :24, launched by ssm_scan at :61, pallas_call at :80).
// That kernel walks a sequential grid axis of chunks with the (block_di x
// ds) state in VMEM scratch and evaluates each chunk with an associative
// scan.  Here the sequential form of the same recurrence runs in the lanes
// of each (row, channel): channel d's state depends on no other channel,
// and blocks on this card run in no order, so nothing is carried between
// them.
//
// What bounds it on this card: it reads u, dt once and writes y once per
// (row, step, channel) (10 bytes with u in bf16, 12 in f32), plus the small
// B, C, A, D and the state; at the main path's prefill (Bz = 1, di = 16384,
// S = 256) that is ~45 MB, 13.5 us at 3.35 TB/s, and at its decode step
// (Bz = 4, S = 1) the 4 MB state read and the 4 MB state written, 3 us.
// Its arithmetic is ~7 f32 operations and one exp per (row, step, channel,
// state): the 67 M exps of the prefill take ~18 us of the special-function
// units at 16 a clock an SM, and the ~32 instructions a lane issues per step
// (4 of them shared-memory loads) about as long.  On the card the issue of
// those instructions sets the pace: the same kernel with each ex2 replaced
// by an FMA takes as long.
//
// What the design does about it:
//  * d_state is split over lanes: DS / 4 lanes a channel, 4 states each as
//    a float4 (a warp is 8 channels x 16 states, or 16 x 8), so the loads of
//    h0 and A_log and the store of h_out are 16 bytes a lane on neighbouring
//    addresses, fully coalesced; DS (8 or 16) is a template parameter;
//  * the prefill grid has 4x the warps of one thread per channel (16 an SM
//    at jamba's shape), so the steps of different warps hide each other's
//    latency; within a lane the 4 state updates of a step are independent,
//    and the exps depend on no earlier step;
//  * y sums over a channel's lanes by a reduce-scatter of LPC steps at once
//    (__shfl_xor_sync: 3 shuffles for 4 steps, not 8), so each lane stores
//    y of one step; u * D enters through the channel's first lane;
//  * u and dt reach the block as whole tiles (16 steps x the block's
//    channels) by cp.async, 16 bytes a copy, two tiles ahead in a ring of
//    three: a warp's own loads would be 16-32 bytes a step (8 channels), too
//    few bytes in flight to cover the memory's latency;
//  * B and C of the next tile are loaded into registers while this tile's
//    steps run and go through a double-buffered shared-memory tile as f32,
//    read as float4 (a broadcast to the lanes of one quarter);
//  * steps past S run with dt = u = 0, which leaves h exactly as it is, and
//    groups of steps wholly past S are skipped; a whole tile of real steps
//    runs without either;
//  * a decode step (S = 1) runs ssm_step_kernel: no tiles, no shared memory,
//    few registers, so the grid's state loads are all in flight at once;
//  * h_out may be h0: each lane reads its own states before it writes them;
//  * a = -exp(A_log) is pre-scaled by log2 e, so each exp is one ex2; all
//    arithmetic is in f32, as in the reference;
//  * under grad mode the caller passes ckpt, and each tile's entering state
//    (16 bytes a lane, coalesced, like h_out) is written there for the
//    backward (csrc/ssm_scan_bwd.cu); serving passes null and writes no
//    more than before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssm_checkpoint.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = kSsmCheckpoint;        // time steps a tile of a prompt
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// A tile's B and C (kTile steps), held in registers until the tile before it
// is done, then staged in shared memory as f32
template <typename T, int DS>
struct BCRegs {
  static constexpr int kPer = (kTile * DS + kThreads - 1) / kThreads;  // B, C a thread
  T b[kPer], c[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ Bm, const T* __restrict__ Cm,
                                       size_t row, int t0, int tn) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const size_t g = (row + t0) * DS + min((int)threadIdx.x + j * kThreads, tn * DS - 1);
      b[j] = Bm[g];
      c[j] = Cm[g];
    }
  }

  __device__ __forceinline__ void stage(float (*s_b)[DS], float (*s_c)[DS]) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = (int)threadIdx.x + j * kThreads;
      if (i < kTile * DS) {
        s_b[i / DS][i % DS] = to_f32(b[j]);
        s_c[i / DS][i % DS] = to_f32(c[j]);
      }
    }
  }
};

// Copy the block's CPB channels of `tn` steps of src ((steps, di) rows
// from `at`) into dst (kTile x CPB): 16 bytes a cp.async where `vec` (rows
// and src 16-byte aligned), else element by element.  Channels past di and
// steps past tn are left as they are (never read as live).
template <typename E, int CPB>
__device__ __forceinline__ void fetch(E (*dst)[CPB], const E* __restrict__ at, int tn,
                                      int di, int c0, bool vec) {
  constexpr int G = 16 / sizeof(E), CH = kTile * CPB / G;   // 16-byte chunks a tile
  if (vec) {
    for (int idx = threadIdx.x; idx < CH; idx += kThreads) {
      const int t = idx / (CPB / G), ch = (idx % (CPB / G)) * G;
      if (t < tn && c0 + ch < di) cp_async16(&dst[t][ch], at + (size_t)t * di + c0 + ch);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * CPB; idx += kThreads) {
      const int t = idx / CPB, ch = idx % CPB;
      if (t < tn && c0 + ch < di) dst[t][ch] = at[(size_t)t * di + c0 + ch];
    }
  }
}

// p[m] is this lane's part of y at step m of a group of LPC steps; returns
// the channel's y at step q (the lane's index in its channel)
template <int LPC>
__device__ __forceinline__ float reduce_scatter(const float (&p)[LPC], int q) {
  if constexpr (LPC == 4) {
    const bool hi = q & 2, lo = q & 1;
    float k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
    k0 += __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
    k1 += __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
    return (lo ? k1 : k0) + __shfl_xor_sync(0xffffffffu, lo ? k0 : k1, 1);
  } else {
    static_assert(LPC == 2, "DS is 8 or 16");
    const bool lo = q & 1;
    return (lo ? p[1] : p[0]) + __shfl_xor_sync(0xffffffffu, lo ? p[0] : p[1], 1);
  }
}

// The steps of one tile for this lane's 4 states of h.  kFull: all kTile
// steps are real (no masks, no early exit); otherwise steps past tn run with
// dt = u = 0 (h stays as it is) and groups wholly past tn are skipped.
// s_u, s_dt: the tile's u and dt, column cl this lane's channel; yt: y at
// (b, t0, d).
template <typename T, int DS, int CPB, bool kFull>
__device__ __forceinline__ void run_tile(const T (*s_u)[CPB], const float (*s_dt)[CPB],
                                         const float (*s_b)[DS], const float (*s_c)[DS],
                                         float4& h, const float4& a, float ud, int q, int cl,
                                         int tn, float* yt, int di, bool ok) {
  constexpr int LPC = DS / 4;
  const int s0 = 4 * q;
#pragma unroll
  for (int g = 0; g < kTile / LPC; ++g) {
    if (!kFull && g * LPC >= tn) break;      // uniform over the block
    float p[LPC];
#pragma unroll
    for (int m = 0; m < LPC; ++m) {
      const int t = g * LPC + m;
      const bool live = kFull || t < tn;
      const float ut = live ? to_f32(s_u[t][cl]) : 0.f;
      const float dtt = live ? s_dt[t][cl] : 0.f;
      const float dbu = dtt * ut;
      const float4 b = *reinterpret_cast<const float4*>(&s_b[t][s0]);
      const float4 c = *reinterpret_cast<const float4*>(&s_c[t][s0]);
      h.x = fmaf(exp2_approx(dtt * a.x), h.x, dbu * b.x);
      h.y = fmaf(exp2_approx(dtt * a.y), h.y, dbu * b.y);
      h.z = fmaf(exp2_approx(dtt * a.z), h.z, dbu * b.z);
      h.w = fmaf(exp2_approx(dtt * a.w), h.w, dbu * b.w);
      p[m] = fmaf(ut, ud, fmaf(h.x, c.x, h.y * c.y) + fmaf(h.z, c.z, h.w * c.w));
    }
    const float yq = reduce_scatter<LPC>(p, q);
    if (ok && (kFull || g * LPC + q < tn)) yt[(size_t)(g * LPC + q) * di] = yq;
  }
}

// u: (Bz, S, di) of T; dt: (Bz, S, di) f32; A_log: (di, DS) f32; Bm, Cm:
// (Bz, S, DS) of T; Dv: (di,) f32; h0, h_out: (Bz, di, DS) f32 (h_out may
// be h0); y: (Bz, S, di) f32; ckpt: null, or (Bz, ceil(S / kTile), di, DS)
// f32 that gets the state entering each tile (the backward's checkpoints);
// all contiguous.  Grid (ceil(di / CPB), Bz)
// with CPB = kThreads / (DS / 4) channels a block.  vec: bit 0 u, bit 1 dt
// rows 16-byte aligned.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads, 4)
ssm_kernel(const T* __restrict__ u, const float* __restrict__ dt,
           const float* __restrict__ A_log, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           const float* h0, float* __restrict__ y, float* h_out, float* __restrict__ ckpt,
           int S, int di, int vec) {
  constexpr int LPC = DS / 4;                // lanes a channel
  constexpr int CPB = kThreads / LPC;        // channels a block
  constexpr int kStages = 3;                 // tiles of u, dt in flight or in use
  __shared__ __align__(16) T s_u[kStages][kTile][CPB];
  __shared__ __align__(16) float s_dt[kStages][kTile][CPB];
  __shared__ __align__(16) float s_b[2][kTile][DS];
  __shared__ __align__(16) float s_c[2][kTile][DS];

  const int q = threadIdx.x % LPC, cl = threadIdx.x / LPC;
  const int c0 = blockIdx.x * CPB;
  const int d = c0 + cl;
  const bool ok = d < di;
  const int dc = min(d, di - 1);
  const size_t row = (size_t)blockIdx.y * S;      // index of (b, t = 0)
  const size_t hs = ((size_t)blockIdx.y * di + dc) * DS + 4 * q;
  const int ntiles = (S + kTile - 1) / kTile;

  // u and dt: tiles 0 and 1 in flight before anything else
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int t0 = tile * kTile, tn = min(kTile, S - t0), st = tile % kStages;
      fetch<T, CPB>(s_u[st], u + (row + t0) * di, tn, di, c0, vec & 1);
      fetch<float, CPB>(s_dt[st], dt + (row + t0) * di, tn, di, c0, vec & 2);
    }
    asm volatile("cp.async.commit_group;");
  };
  issue(0);
  issue(1);

  float4 a = *reinterpret_cast<const float4*>(A_log + (size_t)dc * DS + 4 * q);
  float4 h = *reinterpret_cast<const float4*>(h0 + hs);
  const float ud = q == 0 ? Dv[dc] : 0.f;     // u * D, through the first lane
  a = make_float4(-expf(a.x) * kLog2e, -expf(a.y) * kLog2e, -expf(a.z) * kLog2e,
                  -expf(a.w) * kLog2e);
  BCRegs<T, DS> bc;
  bc.load(Bm, Cm, row, 0, min(kTile, S));
  bc.stage(s_b[0], s_c[0]);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * kTile, tn = min(kTile, S - t0), buf = tile & 1, st = tile % kStages;
    // the state entering the tile, kept for the backward (grad mode only)
    if (ckpt != nullptr && ok)
      *reinterpret_cast<float4*>(ckpt + (((size_t)blockIdx.y * ntiles + tile) * di + dc) * DS +
                                 4 * q) = h;
    asm volatile("cp.async.wait_group 1;");  // this tile's u, dt are here
    __syncthreads();                         // for every thread; the last tile is done
    issue(tile + 2);                         // into the stage the last tile used
    if (tile + 1 < ntiles) bc.load(Bm, Cm, row, t0 + kTile, min(kTile, S - t0 - kTile));
    float* yt = y + (row + t0) * di + d;
    if (tn == kTile)
      run_tile<T, DS, CPB, true>(s_u[st], s_dt[st], s_b[buf], s_c[buf], h, a, ud, q,
                                       cl, tn, yt, di, ok);
    else
      run_tile<T, DS, CPB, false>(s_u[st], s_dt[st], s_b[buf], s_c[buf], h, a, ud, q,
                                        cl, tn, yt, di, ok);
    if (tile + 1 < ntiles) bc.stage(s_b[buf ^ 1], s_c[buf ^ 1]);
  }

  if (ok) *reinterpret_cast<float4*>(h_out + hs) = h;
}

// One step from the carried state (S = 1, the decode step): no tiles and no
// shared memory, only the state's 16-byte loads and stores in flight, with
// registers for 16 blocks an SM, so the whole grid's state moves at once.
// Shapes as ssm_kernel's with S = 1.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
ssm_step_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* h0, float* __restrict__ y, float* h_out, int di) {
  constexpr int LPC = DS / 4, CPB = kThreads / LPC;
  const int q = threadIdx.x % LPC;
  const int d = blockIdx.x * CPB + threadIdx.x / LPC;
  const bool ok = d < di;
  const int dc = min(d, di - 1);
  const size_t b = blockIdx.y, hs = (b * di + dc) * DS + 4 * q;
  float4 a = *reinterpret_cast<const float4*>(A_log + (size_t)dc * DS + 4 * q);
  float4 h = *reinterpret_cast<const float4*>(h0 + hs);
  const float ut = to_f32(u[b * di + dc]), dtt = dt[b * di + dc], dd = Dv[dc];
  float bb[4], cc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    bb[m] = to_f32(Bm[b * DS + 4 * q + m]);
    cc[m] = to_f32(Cm[b * DS + 4 * q + m]);
  }
  a = make_float4(-expf(a.x) * kLog2e, -expf(a.y) * kLog2e, -expf(a.z) * kLog2e,
                  -expf(a.w) * kLog2e);
  const float dbu = dtt * ut;
  h.x = fmaf(exp2_approx(dtt * a.x), h.x, dbu * bb[0]);
  h.y = fmaf(exp2_approx(dtt * a.y), h.y, dbu * bb[1]);
  h.z = fmaf(exp2_approx(dtt * a.z), h.z, dbu * bb[2]);
  h.w = fmaf(exp2_approx(dtt * a.w), h.w, dbu * bb[3]);
  float p = fmaf(h.x, cc[0], h.y * cc[1]) + fmaf(h.z, cc[2], h.w * cc[3]);
#pragma unroll
  for (int o = LPC / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if (ok && q == 0) y[b * di + d] = fmaf(ut, dd, p);
  if (ok) *reinterpret_cast<float4*>(h_out + hs) = h;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int DS>
cudaError_t launch(const void* u, const void* dt, const void* A_log,
                   const void* Bm, const void* Cm, const void* Dv,
                   const void* h0, void* y, void* h_out, void* ckpt, int Bz, int S,
                   int di, cudaStream_t stream) {
  constexpr int CPB = kThreads / (DS / 4);
  const dim3 grid((di + CPB - 1) / CPB, Bz);
  if (S == 1 && ckpt == nullptr) {
    ssm_step_kernel<T, DS><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(u), static_cast<const float*>(dt),
        static_cast<const float*>(A_log), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(Dv),
        static_cast<const float*>(h0), static_cast<float*>(y),
        static_cast<float*>(h_out), di);
    return cudaGetLastError();
  }
  const int vec = ((di * sizeof(T) % 16 == 0 && aligned16(u)) ? 1 : 0) |
                  ((di % 4 == 0 && aligned16(dt)) ? 2 : 0);
  ssm_kernel<T, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<float*>(ckpt), S, di, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* u, const void* dt, const void* A_log,
                      const void* Bm, const void* Cm, const void* Dv,
                      const void* h0, void* y, void* h_out, void* ckpt, int Bz, int S,
                      int di, int ds, cudaStream_t stream) {
  if (ds == 8)
    return launch<T, 8>(u, dt, A_log, Bm, Cm, Dv, h0, y, h_out, ckpt, Bz, S, di, stream);
  if (ds == 16)
    return launch<T, 16>(u, dt, A_log, Bm, Cm, Dv, h0, y, h_out, ckpt, Bz, S, di, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// u, B, C: dtype 0 = float32, 1 = bfloat16; u: (Bz, S, di); B, C: (Bz, S,
// ds); dt: (Bz, S, di) f32; A_log: (di, ds) f32; D: (di,) f32; h0, h_out:
// (Bz, di, ds) f32, h_out = h0 allowed; y: (Bz, S, di) f32; ckpt: null
// (serving: nothing more is written), or (Bz, ceil(S / kTile), di, ds) f32
// for the state entering every kTile-th step (grad mode: the backward's
// checkpoints; S = 1 then runs ssm_kernel); ckpt_steps: the caller's
// interval between checkpoints, which must be kTile when ckpt is given; ds
// 8 or 16; all contiguous and 16-byte aligned on the device.  Returns the
// launch's cudaError_t (0 when it was accepted).
extern "C" int ssm_scan(const void* u, const void* dt, const void* A_log,
                        const void* B, const void* C, const void* D,
                        const void* h0, void* y, void* h_out, void* ckpt, int Bz,
                        int S, int di, int ds, int dtype, int ckpt_steps, void* stream) {
  if (Bz <= 0 || Bz > 65535 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  if (ckpt != nullptr && ckpt_steps != kTile) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ds<float>(u, dt, A_log, B, C, D, h0, y, h_out, ckpt, Bz, S, di, ds, st);
  if (dtype == 1)
    return launch_ds<__nv_bfloat16>(u, dt, A_log, B, C, D, h0, y, h_out, ckpt, Bz, S, di, ds,
                                    st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
