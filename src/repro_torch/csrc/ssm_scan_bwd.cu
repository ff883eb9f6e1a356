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
// (row, step, channel, state) it runs ~15 f32 operations and one ex2, and
// per step the sums of dB and dC over every channel.
//
// What the design does about it:
//  * lanes as the forward's: d_state over DS / 4 lanes a channel, 4 states a
//    lane as a float4, a block CPB = 64 (DS 16) or 128 (DS 8) channels of one
//    row; a grid of (ceil(di / CPB), Bz) blocks, two an SM;
//  * checkpoints: the forward, under grad mode, writes the state entering
//    every kCkpt = 8 steps (ssm_checkpoint.cuh; 16 bytes a lane, coalesced):
//    134 MB at the training shape (67 MB at 16 steps).  The backward walks
//    tiles of kTile = 16 steps in reverse, each as two intervals of 8: it
//    reloads the interval's entering state, recomputes its 8 states with the
//    forward's own arithmetic, keeping each decay da in registers (8 float4s
//    a lane) and each state in shared memory (each thread its own slots: 16
//    bytes a step, no barrier), and walks them back, so every decay is taken
//    once.  It never divides by da_t, which underflows to 0 where dt a is
//    large.  With the states of 16 steps in registers as well, the walk
//    took 157 registers; here 128, no spills;
//  * u, dt, dy arrive by cp.async, 16 bytes a copy where the rows allow, two
//    tiles ahead of the walk in a ring of three (as the forward's); B and C
//    of the next tile are loaded into registers during the walk and staged
//    as f32; channels past di read zeros, so their lanes add nothing;
//  * du and ddt sum over a channel's lanes by a reduce-scatter of LPC steps
//    at once (each lane then holds one step's sums) and are stored from the
//    lanes;
//  * dB and dC sum over channels: over a warp's channels by a reduce-scatter
//    (7 shuffles a lane a step for its 8 terms, where a butterfly took 24),
//    then over the block's warps in warp order, and each block writes its
//    partial: 33.5 MB at the training shape (67 MB at 32 channels a
//    block).  dA_log's and dD's sums over steps stay in registers and each
//    row writes its partial;
//  * ssm_bwd_reduce_kernel then adds the partials in a fixed order (block by
//    block in kSlices runs, the runs in order, for dB, dC; row by row for
//    dA_log, dD): no atomics on data, so the result is the same bits from
//    call to call;
//  * bf16 u, B, C: all arithmetic in f32; du, dB, dC are written in bf16.
// Tried on an H100 and not kept (PERF.md): summing dB, dC over a
// cluster of 8 blocks through distributed shared memory (the walk 110-270
// us slower: the blocks of a cluster wait on each other every tile); the
// decays in shared memory as well; 128 threads a block; u, dt, dy
// interleaved in one float4 a (step, channel) through registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssm_checkpoint.cuh"

namespace {

constexpr int kThreads = 256;                // threads a block of the walk
constexpr int kMinBlocks = 2;                // blocks an SM the walk is built for
constexpr int kCkpt = kSsmCheckpoint;        // steps between the forward's checkpoints
constexpr int kTile = 2 * kCkpt;             // steps a tile of u, dt, dy
constexpr int kStages = 3;                   // tiles in flight or in use
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// Copy the block's CPB channels of `tn` steps of src ((steps, di) rows from
// `at`) into dst (kTile x CPB): 16 bytes a cp.async where `vec` (rows and
// src 16-byte aligned), else element by element.  Channels past di and
// steps past tn are left as they are.
template <typename E, int CPB>
__device__ __forceinline__ void fetch(E (*dst)[CPB], const E* __restrict__ at, int tn,
                                      int di, int c0, bool vec) {
  constexpr int G = 16 / sizeof(E), CH = kTile * CPB / G;
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

// A tile's B and C, held in registers while the tile before it is walked,
// then staged in shared memory as f32 (the forward's way)
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

// p[m]: this lane's part of a channel's sum at step m of a group of LPC
// steps; returns the channel's sum at step q (the lane's index in its
// channel), by a reduce-scatter over the channel's lanes
template <int LPC>
__device__ __forceinline__ float sum_lanes(const float (&p)[LPC], int q) {
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

// p: this lane's terms of dB (p[0..3]) and dC (p[4..7]) for its 4 states;
// returns one of them summed over the warp's channels (the lanes of equal
// q), by a reduce-scatter: 7 shuffles (8 for DS 8, whose 16 channels end in
// a butterfly).  *e: the value's index in a step's 2 DS (dB's states, then
// dC's).
template <int DS>
__device__ __forceinline__ float sum_channels(float (&p)[8], int lane, int* e) {
  constexpr int LPC = DS / 4;
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {             // xor 16, 8, 4: values 8 -> 1
    const int o = 4 * w;
    const bool up = lane & o;
#pragma unroll
    for (int m = 0; m < w; ++m)
      p[m] = (up ? p[m + w] : p[m]) + __shfl_xor_sync(0xffffffffu, up ? p[m] : p[m + w], o);
  }
  if constexpr (LPC == 2) p[0] += __shfl_xor_sync(0xffffffffu, p[0], 2);
  const int val = (lane >> 2) & 7;           // the kept value: bits of lane / 4
  const int q = lane % LPC;
  *e = val < 4 ? 4 * q + val : DS + 4 * q + val - 4;
  return p[0];
}

// ssm_bwd_kernel's dynamic shared memory, in bytes: the states of one
// interval (kCkpt float4s a thread, each thread its own); kStages tiles of
// dt, dy (f32) and u (T), kTile x CPB each; B and C of two tiles as f32
// (kTile x DS each); each warp's sums of dB, dC over its channels (kWarps x
// kTile x 2 DS).
template <typename T, int DS>
struct BwdSmem {
  static constexpr int LPC = DS / 4, CPB = kThreads / LPC, NV = 2 * DS;
  static constexpr size_t TILE = (size_t)kTile * CPB;
  static constexpr size_t H = 0, DT = H + (size_t)kCkpt * kThreads * 16;
  static constexpr size_t DY = DT + kStages * TILE * 4, U = DY + kStages * TILE * 4;
  static constexpr size_t B = U + kStages * TILE * sizeof(T), C = B + 2 * kTile * DS * 4;
  static constexpr size_t RED = C + 2 * kTile * DS * 4, END = RED + (size_t)kWarps * kTile * NV * 4;
};

// u: (Bz, S, di) of T; dt, dy: (Bz, S, di) f32; A_log: (di, DS) f32; Bm, Cm:
// (Bz, S, DS) of T; Dv: (di,) f32; ckpt: (Bz, nck, di, DS) f32, the state
// entering every kCkpt steps (nck = ceil(S / kCkpt)); dh: (Bz, di, DS) f32
// or null.  Writes du (Bz, S, di) of T, ddt (Bz, S, di) f32, dh0 (Bz, di,
// DS) f32, and partial sums: part_bc (gridDim.x, Bz, S, 2 DS) f32 (dB then
// dC of the block's channels), part_a (Bz, di, DS) and part_d (Bz, di) f32
// (dA_log and dD of each row).  Grid (ceil(di / CPB), Bz).  vec: bit 0 u,
// bit 1 dt, bit 2 dy rows 16-byte aligned.
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ ckpt, const float* __restrict__ dy,
               const float* __restrict__ dh, T* __restrict__ du, float* __restrict__ ddt,
               float* __restrict__ dh0, float* __restrict__ part_bc,
               float* __restrict__ part_a, float* __restrict__ part_d, int S, int di, int vec) {
  using L = BwdSmem<T, DS>;
  constexpr int LPC = L::LPC, CPB = L::CPB, NV = L::NV;
  extern __shared__ __align__(16) unsigned char smem[];
  float4 (*s_h)[kThreads] = reinterpret_cast<float4 (*)[kThreads]>(smem + L::H);
  float (*s_dt)[kTile][CPB] = reinterpret_cast<float (*)[kTile][CPB]>(smem + L::DT);
  float (*s_dy)[kTile][CPB] = reinterpret_cast<float (*)[kTile][CPB]>(smem + L::DY);
  T (*s_u)[kTile][CPB] = reinterpret_cast<T (*)[kTile][CPB]>(smem + L::U);
  float (*s_b)[kTile][DS] = reinterpret_cast<float (*)[kTile][DS]>(smem + L::B);
  float (*s_c)[kTile][DS] = reinterpret_cast<float (*)[kTile][DS]>(smem + L::C);
  float (*s_red)[kTile][NV] = reinterpret_cast<float (*)[kTile][NV]>(smem + L::RED);

  const int q = threadIdx.x % LPC, cl = threadIdx.x / LPC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * CPB;
  const int d = c0 + cl;
  const bool ok = d < di;
  const int dc = min(d, di - 1);
  const int b = blockIdx.y, Bz = gridDim.y;
  const size_t row = (size_t)b * S;                // index of (b, t = 0)
  const size_t hs = ((size_t)b * di + dc) * DS + 4 * q;
  const int ntiles = (S + kTile - 1) / kTile, nck = (S + kCkpt - 1) / kCkpt;

  if (c0 + CPB > di) {                       // channels past di: zeros, never copied over
    for (int i = threadIdx.x; i < kStages * kTile * CPB; i += kThreads) {
      (&s_u[0][0][0])[i] = from_f32<T>(0.f);
      (&s_dt[0][0][0])[i] = 0.f;
      (&s_dy[0][0][0])[i] = 0.f;
    }
    __syncthreads();
  }
  auto issue = [&](int tile) {               // tile's u, dt, dy into its stage
    if (tile >= 0) {
      const int t0 = tile * kTile, tn = min(kTile, S - t0), st = tile % kStages;
      fetch<T, CPB>(s_u[st], u + (row + t0) * di, tn, di, c0, vec & 1);
      fetch<float, CPB>(s_dt[st], dt + (row + t0) * di, tn, di, c0, vec & 2);
      fetch<float, CPB>(s_dy[st], dy + (row + t0) * di, tn, di, c0, vec & 4);
    }
    asm volatile("cp.async.commit_group;");
  };
  issue(ntiles - 1);
  issue(ntiles - 2);

  // a = -exp(A_log) in log2 units, as the forward takes it; the terms of
  // ddt and dA_log in a are these times ln 2
  float4 a2 = f4(A_log + (size_t)dc * DS + 4 * q);
  a2 = make_float4(-expf(a2.x) * kLog2e, -expf(a2.y) * kLog2e, -expf(a2.z) * kLog2e,
                   -expf(a2.w) * kLog2e);
  const float dd = Dv[dc];
  float4 g = dh != nullptr ? f4(dh + hs) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dA = make_float4(0.f, 0.f, 0.f, 0.f);
  float dD = 0.f;
  BCRegs<T, DS> bc;
  {
    const int t0 = (ntiles - 1) * kTile;
    bc.load(Bm, Cm, row, t0, S - t0);
    bc.stage(s_b[(ntiles - 1) & 1], s_c[(ntiles - 1) & 1]);
  }

  for (int c = ntiles - 1; c >= 0; --c) {
    const int t0 = c * kTile, tn = min(kTile, S - t0), st = c % kStages, buf = c & 1;
    asm volatile("cp.async.wait_group 1;");  // this tile's u, dt, dy are here
    __syncthreads();                         // for every thread; the last tile is done
    issue(c - 2);                            // into the stage the last tile used
    if (c > 0) bc.load(Bm, Cm, row, t0 - kTile, kTile);
    const T (*su)[CPB] = s_u[st];
    const float (*sdt)[CPB] = s_dt[st];
    const float (*sdy)[CPB] = s_dy[st];
    const float (*sb)[DS] = s_b[buf];
    const float (*sc)[DS] = s_c[buf];

    // the tile's two intervals, the later first (steps past S: skipped,
    // uniform over the block)
#pragma unroll
    for (int half = kTile / kCkpt - 1; half >= 0; --half) {
      const int base = half * kCkpt, n = min(kCkpt, tn - base);
      if (n <= 0) continue;
      const float4 h_in = f4(ckpt + (((size_t)b * nck + t0 / kCkpt + half) * di + dc) * DS + 4 * q);
      // the interval's states (to shared memory) and decays (in registers),
      // as the forward computes them
      float4 da[kCkpt];
      {
        float4 h = h_in;
#pragma unroll
        for (int m = 0; m < kCkpt; ++m) {
          if (m >= n) break;
          const float dtt = sdt[base + m][cl], dbu = dtt * to_f32(su[base + m][cl]);
          const float4 bb = f4(&sb[base + m][4 * q]);
          da[m] = make_float4(exp2_approx(dtt * a2.x), exp2_approx(dtt * a2.y),
                              exp2_approx(dtt * a2.z), exp2_approx(dtt * a2.w));
          h.x = fmaf(da[m].x, h.x, dbu * bb.x);
          h.y = fmaf(da[m].y, h.y, dbu * bb.y);
          h.z = fmaf(da[m].z, h.z, dbu * bb.z);
          h.w = fmaf(da[m].w, h.w, dbu * bb.w);
          s_h[m][threadIdx.x] = h;
        }
      }
      // the walk back, LPC steps at a time; hm = h of step m
      float4 hm = s_h[n - 1][threadIdx.x];
#pragma unroll
      for (int grp = kCkpt / LPC - 1; grp >= 0; --grp) {
        float gb[LPC], ga[LPC];
#pragma unroll
        for (int j = LPC - 1; j >= 0; --j) {
          const int m = grp * LPC + j, t = base + m;
          gb[j] = ga[j] = 0.f;
          if (m >= n) continue;
          const float dyt = sdy[t][cl], ut = to_f32(su[t][cl]), dtt = sdt[t][cl];
          const float4 bb = f4(&sb[t][4 * q]), cc = f4(&sc[t][4 * q]);
          const float4 hp = m > 0 ? s_h[m > 0 ? m - 1 : 0][threadIdx.x] : h_in;
          g.x = fmaf(dyt, cc.x, g.x);
          g.y = fmaf(dyt, cc.y, g.y);
          g.z = fmaf(dyt, cc.z, g.z);
          g.w = fmaf(dyt, cc.w, g.w);
          const float4 gd = make_float4(g.x * da[m].x, g.y * da[m].y, g.z * da[m].z,
                                        g.w * da[m].w);   // g of the step before
          const float4 gdh = make_float4(gd.x * hp.x, gd.y * hp.y, gd.z * hp.z, gd.w * hp.w);
          gb[j] = fmaf(g.x, bb.x, g.y * bb.y) + fmaf(g.z, bb.z, g.w * bb.w);
          ga[j] = fmaf(gdh.x, a2.x, gdh.y * a2.y) + fmaf(gdh.z, a2.z, gdh.w * a2.w);
          dA.x = fmaf(gdh.x, dtt, dA.x);
          dA.y = fmaf(gdh.y, dtt, dA.y);
          dA.z = fmaf(gdh.z, dtt, dA.z);
          dA.w = fmaf(gdh.w, dtt, dA.w);
          const float dbu = dtt * ut;
          float p[8] = {g.x * dbu, g.y * dbu, g.z * dbu, g.w * dbu,
                        hm.x * dyt, hm.y * dyt, hm.z * dyt, hm.w * dyt};
          int e;
          const float sum = sum_channels<DS>(p, lane, &e);
          if (LPC == 4 || !(lane & 2)) s_red[warp][t][e] = sum;
          g = gd;
          hm = hp;
        }
        // du, ddt of step base + grp * LPC + q, from this lane
        const float gbq = sum_lanes<LPC>(gb, q), gaq = sum_lanes<LPC>(ga, q);
        const int t = base + grp * LPC + q;
        if (t < tn) {
          const float dyt = sdy[t][cl], ut = to_f32(su[t][cl]), dtt = sdt[t][cl];
          dD = fmaf(dyt, ut, dD);
          if (ok) {
            const size_t at = (row + t0 + t) * di + d;
            du[at] = from_f32<T>(fmaf(dtt, gbq, dyt * dd));
            ddt[at] = fmaf(ut, gbq, gaq * kLn2);
          }
        }
      }
    }
    __syncthreads();                         // every warp's sums of the tile are in s_red
    // the block's sums of the tile's dB, dC, warps in order
    for (int i = threadIdx.x; i < kTile * NV; i += kThreads) {
      const int t = i / NV, e = i % NV;
      if (t < tn) {
        float sum = s_red[0][t][e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += s_red[w][t][e];
        part_bc[(((size_t)blockIdx.x * Bz + b) * S + t0 + t) * NV + e] = sum;
      }
    }
    if (c > 0) bc.stage(s_b[buf ^ 1], s_c[buf ^ 1]);
  }

#pragma unroll
  for (int o = LPC / 2; o > 0; o >>= 1) dD += __shfl_xor_sync(0xffffffffu, dD, o);
  if (ok) {
    *reinterpret_cast<float4*>(dh0 + hs) = g;
    *reinterpret_cast<float4*>(part_a + hs) =
        make_float4(dA.x * a2.x * kLn2, dA.y * a2.y * kLn2, dA.z * a2.z * kLn2,
                    dA.w * a2.w * kLn2);
    if (q == 0) part_d[(size_t)b * di + d] = dD;
  }
}

// The fixed-order sums of the partials.  dB, dC (Bz, S, DS) of T over the np
// blocks of channels: a block a run of 32 float4s of the partials' rows,
// kSlices warps each adding its slice of the np partials in order, then the
// slices added in order; dA_log (di, DS) and dD (di,) f32 over the Bz rows,
// row 0 first, in the last blocks.  The order is fixed: the same bits from
// call to call.
constexpr int kSlices = 8;

template <typename T, int DS>
__global__ void __launch_bounds__(32 * kSlices)
ssm_bwd_reduce_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                      const float* __restrict__ part_d, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA_log, float* __restrict__ dD, int Bz, int S,
                      int di, int np) {
  __shared__ float4 s_part[kSlices][32];
  const size_t n4 = (size_t)Bz * S * 2 * DS / 4;
  const size_t nb4 = (n4 + 31) / 32;          // blocks for dB, dC
  if (blockIdx.x < nb4) {
    const int slice = threadIdx.x / 32;
    const size_t i = blockIdx.x * (size_t)32 + threadIdx.x % 32;
    const int x0 = (int)((long long)np * slice / kSlices);
    const int x1 = (int)((long long)np * (slice + 1) / kSlices);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n4) {
      const float4* src = reinterpret_cast<const float4*>(part_bc) + i;
      int x = x0;
      for (; x + 4 <= x1; x += 4) {            // four loads in flight, added in order
        float4 y[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) y[k] = src[(size_t)(x + k) * n4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sum = make_float4(sum.x + y[k].x, sum.y + y[k].y, sum.z + y[k].z, sum.w + y[k].w);
      }
      for (; x < x1; ++x) {
        const float4 y = src[(size_t)x * n4];
        sum = make_float4(sum.x + y.x, sum.y + y.y, sum.z + y.z, sum.w + y.w);
      }
    }
    s_part[slice][threadIdx.x % 32] = sum;
    __syncthreads();
    if (slice == 0 && i < n4) {
#pragma unroll
      for (int k = 1; k < kSlices; ++k) {
        const float4 y = s_part[k][threadIdx.x];
        sum = make_float4(sum.x + y.x, sum.y + y.y, sum.z + y.z, sum.w + y.w);
      }
      const size_t bt = i * 4 / (2 * DS);
      const int e = (int)(i * 4 % (2 * DS));   // 4 values of dB, or 4 of dC
      T* dst = e < DS ? dB + bt * DS + e : dC + bt * DS + e - DS;
      dst[0] = from_f32<T>(sum.x);
      dst[1] = from_f32<T>(sum.y);
      dst[2] = from_f32<T>(sum.z);
      dst[3] = from_f32<T>(sum.w);
    }
    return;
  }
  const size_t n_a = (size_t)di * DS;
  for (size_t i = (blockIdx.x - nb4) * (size_t)blockDim.x + threadIdx.x; i < n_a + di;
       i += (gridDim.x - nb4) * (size_t)blockDim.x) {
    if (i < n_a) {
      float sum = 0.f;
      for (int b = 0; b < Bz; ++b) sum += part_a[(size_t)b * n_a + i];
      dA_log[i] = sum;
    } else {
      const size_t e = i - n_a;
      float sum = 0.f;
      for (int b = 0; b < Bz; ++b) sum += part_d[(size_t)b * di + e];
      dD[e] = sum;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int DS>
cudaError_t launch(const void* u, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, const void* Dv, const void* ckpt, const void* dy,
                   const void* dh, void* du, void* ddt, void* dA_log, void* dB, void* dC,
                   void* dD, void* dh0, void* part_bc, void* part_a, void* part_d, int Bz,
                   int S, int di, cudaStream_t stream) {
  constexpr int CPB = kThreads / (DS / 4);
  const int np = (di + CPB - 1) / CPB;       // blocks a row, each writing a partial
  // shared memory above 48 KB needs an opt-in, set on every call (cheap)
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_kernel<T, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BwdSmem<T, DS>::END);
  if (err != cudaSuccess) return err;
  const int vec = ((di * sizeof(T) % 16 == 0 && aligned16(u)) ? 1 : 0) |
                  ((di % 4 == 0 && aligned16(dt)) ? 2 : 0) |
                  ((di % 4 == 0 && aligned16(dy)) ? 4 : 0);
  ssm_bwd_kernel<T, DS><<<dim3(np, Bz), kThreads, BwdSmem<T, DS>::END, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(Dv), static_cast<const float*>(ckpt),
      static_cast<const float*>(dy), static_cast<const float*>(dh), static_cast<T*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dh0), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), static_cast<float*>(part_d), S, di, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t nb4 = ((size_t)Bz * S * 2 * DS / 4 + 31) / 32;
  const size_t nb_a = ((size_t)di * (DS + 1) + 32 * kSlices - 1) / (32 * kSlices);
  const size_t blocks = nb4 + (nb_a < 512 ? nb_a : 512);
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidValue;
  ssm_bwd_reduce_kernel<T, DS><<<(unsigned)blocks, 32 * kSlices, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<const float*>(part_d), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA_log), static_cast<float*>(dD), Bz, S, di, np);
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
// A_log, D: as the forward; ckpt: (Bz, ceil(S / kCkpt), di, ds) f32, the
// forward's checkpoints, and ckpt_steps the caller's interval between them
// (it must be kCkpt); dy: (Bz, S, di) f32; dh: (Bz, di, ds) f32 or null
// (zero).  Writes du (u's dtype), ddt, dA_log, dB, dC (B's dtype), dD, dh0
// in the shapes of the forward's inputs, using the f32 scratch part_bc
// (ceil(di / (kThreads / (ds / 4))), Bz, S, 2 ds), part_a (Bz, di, ds)
// and part_d (Bz, di).  All contiguous on the device, A_log, ckpt and dh
// 16-byte aligned; two launches on `stream`.  Returns the first launch
// error (0 when both were accepted).
extern "C" int ssm_scan_bwd(const void* u, const void* dt, const void* A_log, const void* B,
                            const void* C, const void* D, const void* ckpt, const void* dy,
                            const void* dh, void* du, void* ddt, void* dA_log, void* dB,
                            void* dC, void* dD, void* dh0, void* part_bc, void* part_a,
                            void* part_d, int Bz, int S, int di, int ds, int dtype,
                            int ckpt_steps, void* stream) {
  if (Bz <= 0 || Bz > 65535 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  if (ckpt_steps != kCkpt) return cudaErrorInvalidValue;
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
