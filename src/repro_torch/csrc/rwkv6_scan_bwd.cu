// Backward of the RWKV-6 WKV recurrence for Hopper (sm_90a), over N = batch *
// heads rows.  The forward (csrc/rwkv6_scan.cu) is
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t.
// With G_t = dL/dS_t (G_{S-1} = dS, the final state's gradient) and
// G_{t-1} = diag(w_t) G_t + r_t^T dy_t:
//   dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t),
//   dk_t = G_t v_t + r_t o u (v_t . dy_t),
//   dv_t = k_t G_t + (r_t . u o k_t) dy_t,
//   du = sum_t r_t o k_t (v_t . dy_t),  dlogw_t = w_t o sum_v G_t o S_{t-1},
//   dstate0 = G_{-1}.
//
// No TPU counterpart: the Pallas kernel (src/repro/kernels/rwkv6_scan/
// kernel.py, rwkv6_scan at :73) is forward-only, and the JAX model
// differentiates its XLA scan (wkv_chunked, src/repro/models/rwkv6.py:94).
//
// In chunks of C steps, with cum / cum_ex the inclusive / exclusive
// cumulative log-decays from the chunk's start, S_in the state entering the
// chunk (the forward's scratch, kept under grad mode), G_end the gradient of
// the state at its last step, and M[t, i] = dy_t . v_i:
//   dr_t = e^{cum_ex_t} S_in dy_t + sum_{i<t} M[t,i] k_i e^{cum_ex_t - cum_i} + u k_t M[t,t]
//   dk_t = e^{cum_end - cum_t} G_end v_t + sum_{s>t} M[s,t] r_s e^{cum_ex_s - cum_t}
//          + r_t u M[t,t]
//   dv_t = (k_t e^{cum_end - cum_t}) G_end + sum_{s>t} A[s,t] dy_s + bonus_t dy_t
// with A the forward's matrix, and G entering the chunk
//   G_in = e^{cum_end} G_end + sum_s (r_s e^{cum_ex_s})^T dy_s.
// Every exponent is <= 0 (decays run from an earlier step to a later one;
// nothing is factored into exp(a) exp(-b)).
//
// dlogw.  The closed form dlogw_t = sum_{s>t} r o dr - sum_{s>=t} k o dk +
// r_t u k_t M[t,t] + sum_v dS o S_final is a difference of large sums: at
// logw = -8 it is 1.2e-4 off in f32 where |dlogw| is at most 0.043 (the
// f32 recurrence: 8.6e-9).  So the kernel takes w_t sum_v G_t o S_{t-1}
// expanded over the chunk, term by term, each with its own decay:
//   dlogw_t = e^{cum_end} Q + sum_{s>t} r_s o drin_s
//             + sum_{i<t} (k_i o dkend_i + k_i o dkfar_i - r_{i+1} o drfar_{i+1})
// where Q = sum_v S_in o G_end (the pass kernel takes it), drin / dkend are
// dr's and dk's S_in / G_end terms, and drfar / dkfar their in-chunk sums
// without the adjacent step (i < t-1, s > t+1): the adjacent terms, whose
// decay is 1, cancel exactly and are left out, so every term left carries
// at least one step's decay.  In f32 that is 1.4e-8 off f64 at logw = -8
// and 2.6e-6 of dlogw's largest value at -1e-6 (N 4, S 512, hd 64; the
// emulation in tests/test_torch_train_recurrent.py).
//
// What bounds it on this card: bytes, if anything: r, k, v, logw, dy read
// and dr, dk, dv, dlogw written once, plus the entering states, ~185 MB at
// the training shape (N = 128, S = 512, hd 64, f32), 55 us at 3.35 TB/s.
//
// Three launches a call, the forward's in reverse:
//  * wkv_bwd_state_kernel, one block per (row, chunk): the chunk's own
//    contribution to G, dG = (r e^{cum_ex})^T dy, its decay cum_end, and its
//    part of du (all chunks at once);
//  * wkv_bwd_pass_kernel walks each row's chunks from the last, G_in =
//    e^{cum_end} o G_end + dG, one float4 of G a thread (as the forward's
//    pass); it overwrites dG_c with G_end of chunk c, takes Q_c by shuffles
//    over the threads of one row of G, writes dstate0, and sums du's parts
//    over the chunks in order (no atomics);
//  * wkv_bwd_out_kernel, one block per (row, chunk): stages r, k, v, dy and
//    the log-decays, then S_in, then G_end in one buffer of shared memory,
//    computes M, A and the bonus, dr (phase A), dk and dv (phase B), and
//    dlogw by one pass over each column (phase C).  All products in f32 FMA
//    on the CUDA cores, as the forward's.
// hd is padded to HDP = 64 or 128 as in the forward.  This is a first
// kernel, simple and right: A and the in-chunk sums take their
// exponentials directly (no sub-blocks), and nothing is pipelined.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv_chunk.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float e2(float x) { return exp2_approx(fminf(x, 0.f)); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One block per (row n, chunk c), block index n * nc + c.  r, k, v: (N, S,
// hd) of T; dy, logw: (N, S, hd) f32.  Writes dG_c to slot c of gst (N, nc,
// HDP, HDP), the chunk's decay cum_end (log2 units) to wl (N, nc, HDP) and
// its part of du, sum_t r_t o k_t (v_t . dy_t), to dup (N, nc, HDP).
// flags: bit 0 r/k/v vector-loadable, bit 1 logw, bit 2 dy.
template <typename T, int HDP, int C>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ dy, float* __restrict__ gst,
                     float* __restrict__ wl, float* __restrict__ dup, int S, int hd, int nc,
                     int flags) {
  using L = Shape<HDP, C>;
  constexpr int LD = L::LD;
  constexpr int TK = HDP / 16, TJ = HDP / 16;     // dG tile a thread
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem;
  float* s_k = s_r + L::TILE;
  float* s_v = s_k + L::TILE;
  float* s_dy = s_v + L::TILE;
  float* s_cum = s_dy + L::TILE;
  float* s_m = s_cum + L::TILE;                   // M[t, t] = v_t . dy_t

  const int n = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * C, tn = min(C, S - t0);
  const size_t seq = ((size_t)n * S + t0) * hd;
  {
    Rows<T, HDP, C> rr, rk, rv;
    Rows<float, HDP, C> rw, rd;
    rr.load(r + seq, tn, hd, flags & 1);
    rk.load(k + seq, tn, hd, flags & 1);
    rv.load(v + seq, tn, hd, flags & 1);
    rw.load(logw + seq, tn, hd, flags & 2);
    rd.load(dy + seq, tn, hd, flags & 4);
    rr.store(s_r, 1.f);
    rk.store(s_k, 1.f);
    rv.store(s_v, 1.f);
    rw.store(s_cum, kLog2e);
    rd.store(s_dy, 1.f);
  }
  __syncthreads();
  cumsum_columns<HDP, C>(s_cum);
  // v_t . dy_t: a warp a step
  for (int t = threadIdx.x / 32; t < C; t += kThreads / 32) {
    float acc = 0.f;
    for (int ch = threadIdx.x % 32; ch < HDP; ch += 32)
      acc = fmaf(s_v[t * LD + ch], s_dy[t * LD + ch], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x % 32 == 0) s_m[t] = acc;
  }
  __syncthreads();

  const size_t slot = (size_t)n * nc + c;
  for (int ch = threadIdx.x; ch < HDP; ch += kThreads) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) acc = fmaf(s_r[t * LD + ch] * s_k[t * LD + ch], s_m[t], acc);
    dup[slot * HDP + ch] = acc;
    wl[slot * HDP + ch] = s_cum[(C - 1) * LD + ch];
  }
  __syncthreads();
  // r decayed from the chunk's start: exponent cum_ex <= 0
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, ch = idx % HDP;
    if (t > 0) s_r[t * LD + ch] *= e2(s_cum[(t - 1) * LD + ch]);
  }
  __syncthreads();

  // dG[kk, j] = sum_t rd[t, kk] dy[t, j], a TK x TJ tile a thread
  const int k0 = (threadIdx.x / 16) * TK, j0 = (threadIdx.x % 16) * TJ;
  float acc[TK][TJ];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TJ; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int t = 0; t < C; ++t) {
    float rr[TK], dd[TJ];
#pragma unroll
    for (int q = 0; q < TK / 4; ++q) {
      const float4 x = ld4(s_r + t * LD + k0 + 4 * q);
      rr[4 * q] = x.x; rr[4 * q + 1] = x.y; rr[4 * q + 2] = x.z; rr[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < TJ / 4; ++q) {
      const float4 x = ld4(s_dy + t * LD + j0 + 4 * q);
      dd[4 * q] = x.x; dd[4 * q + 1] = x.y; dd[4 * q + 2] = x.z; dd[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int a = 0; a < TK; ++a)
#pragma unroll
      for (int b = 0; b < TJ; ++b) acc[a][b] = fmaf(rr[a], dd[b], acc[a][b]);
  }
  float* dg = gst + slot * HDP * HDP;
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int q = 0; q < TJ / 4; ++q)
      *reinterpret_cast<float4*>(dg + (size_t)(k0 + a) * HDP + j0 + 4 * q) =
          make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
}

// The reverse pass over each row's chunks: one float4 of G a thread, SL =
// HDP^2 / 4 / kThreads blocks a row (block index n * SL + slice), starting
// from dS (N, hd, hd) f32, or zero when dS is null.  For c = nc-1 .. 0: slot
// c of gst gets G_end of chunk c in place of dG_c, Q (N, nc, HDP) gets
// sum_v S_in_c o G_end_c (S_in_c: slot c of states, the forward's scratch),
// and G becomes e^{wl_c} o G + dG_c.  dstate0 (N, hd, hd) gets the last G;
// du (N, hd) the parts of dup summed over the chunks, chunk 0 first.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_pass_kernel(const float* __restrict__ dS, const float* __restrict__ states,
                    float* __restrict__ gst, const float* __restrict__ wl,
                    const float* __restrict__ dup, float* __restrict__ Q,
                    float* __restrict__ dstate0, float* __restrict__ du, int hd, int nc) {
  constexpr int SL = HDP * HDP / 4 / kThreads;
  constexpr int GRP = HDP / 4;                    // threads a row of G (one kk)
  constexpr int kStride = HDP * HDP / 4;          // float4s from one slot to the next
  const int n = blockIdx.x / SL;
  const int f = (blockIdx.x % SL) * kThreads + threadIdx.x;   // float4 index
  const int kk = f * 4 / HDP, j = f * 4 % HDP;
  float x[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    x[m] = (dS != nullptr && kk < hd && j + m < hd)
               ? dS[(size_t)n * hd * hd + (size_t)kk * hd + j + m] : 0.f;
  float4 g = make_float4(x[0], x[1], x[2], x[3]);

  float4* gs = reinterpret_cast<float4*>(gst + (size_t)n * nc * HDP * HDP) + f;
  const float4* ss = reinterpret_cast<const float4*>(states + (size_t)n * nc * HDP * HDP) + f;
  const float* w = wl + (size_t)n * nc * HDP + kk;
  float* qn = Q + (size_t)n * nc * HDP + kk;
  // chunk c's loads are issued while chunk c + 1 is walked
  float4 dgc = gs[(size_t)(nc - 1) * kStride];
  float4 snext = ss[(size_t)(nc - 1) * kStride];
  float wc = w[(size_t)(nc - 1) * HDP];
  for (int c = nc - 1; c >= 0; --c) {
    const float4 d = dgc, si = snext;
    const float dec = exp2_approx(fminf(wc, 0.f));
    if (c > 0) {
      dgc = gs[(size_t)(c - 1) * kStride];
      snext = ss[(size_t)(c - 1) * kStride];
      wc = w[(size_t)(c - 1) * HDP];
    }
    float qp = dot4(si, g, 0.f);
#pragma unroll
    for (int o = GRP / 2; o > 0; o >>= 1) qp += __shfl_xor_sync(0xffffffffu, qp, o);
    if (f % GRP == 0) qn[(size_t)c * HDP] = qp;
    gs[(size_t)c * kStride] = g;                  // G at chunk c's end
    g = make_float4(fmaf(dec, g.x, d.x), fmaf(dec, g.y, d.y), fmaf(dec, g.z, d.z),
                    fmaf(dec, g.w, d.w));
  }
  float* so = dstate0 + (size_t)n * hd * hd + (size_t)kk * hd + j;
  const float y[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (kk < hd && j + m < hd) so[m] = y[m];
  if (blockIdx.x % SL == 0 && threadIdx.x < hd) {
    float acc = 0.f;
    for (int c = 0; c < nc; ++c) acc += dup[((size_t)n * nc + c) * HDP + threadIdx.x];
    du[(size_t)n * hd + threadIdx.x] = acc;
  }
}

// wkv_bwd_out_kernel's shared memory, in floats: r, k, v, dy, cum, and the
// per-(step, channel) terms of dlogw a, rf (r o drfar) and b, each C x LD;
// X (HDP x LD: S_in, then G_end); M and A (C x LDA); the bonus (C) and u
// (HDP)
template <int HDP, int C>
struct BwdOutLayout {
  static constexpr int LD = Shape<HDP, C>::LD, LDA = C + 4, TILE = C * LD;
  static constexpr int R = 0, K = R + TILE, V = K + TILE, DY = V + TILE, CUM = DY + TILE;
  static constexpr int TA = CUM + TILE, TRF = TA + TILE, TB = TRF + TILE;
  static constexpr int X = TB + TILE, M = X + HDP * LD, A = M + C * LDA;
  static constexpr int BONUS = A + C * LDA, U = BONUS + C, END = U + HDP;
};

// One block per (row n, chunk c), block index n * nc + c.  states: the
// forward's entering states; gst: G_end of each chunk (after the pass); Q:
// the pass's sum_v S_in o G_end; u: (N, hd) f32.  Writes dr, dk, dv (N, S,
// hd) of T and dlogw (N, S, hd) f32.  flags as wkv_bwd_state_kernel's.
template <typename T, int HDP, int C>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ states, const float* __restrict__ gst,
                   const float* __restrict__ Q, T* __restrict__ dr, T* __restrict__ dk,
                   T* __restrict__ dv, float* __restrict__ dlogw, int S, int hd, int nc,
                   int flags) {
  using O = BwdOutLayout<HDP, C>;
  constexpr int LD = O::LD, LDA = O::LDA;
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem + O::R;
  float* s_k = smem + O::K;
  float* s_v = smem + O::V;
  float* s_dy = smem + O::DY;
  float* s_cum = smem + O::CUM;
  float* s_a = smem + O::TA;
  float* s_rf = smem + O::TRF;
  float* s_b = smem + O::TB;
  float* s_x = smem + O::X;
  float* s_M = smem + O::M;
  float* s_A = smem + O::A;
  float* s_bonus = smem + O::BONUS;
  float* s_u = smem + O::U;

  const int n = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * C, tn = min(C, S - t0);
  const size_t slot = (size_t)n * nc + c;
  auto stage_x = [&](const float* src) {     // (HDP x HDP) f32 into s_x by cp.async
    for (int idx = threadIdx.x; idx < HDP * HDP / 4; idx += kThreads) {
      const int row = idx / (HDP / 4), q = idx % (HDP / 4);
      cp_async16(s_x + row * LD + 4 * q, src + (size_t)row * HDP + 4 * q);
    }
    asm volatile("cp.async.commit_group;");
  };
  stage_x(states + slot * HDP * HDP);

  const size_t seq = ((size_t)n * S + t0) * hd;
  {
    Rows<T, HDP, C> rr, rk, rv;
    Rows<float, HDP, C> rw, rd;
    rr.load(r + seq, tn, hd, flags & 1);
    rk.load(k + seq, tn, hd, flags & 1);
    rv.load(v + seq, tn, hd, flags & 1);
    rw.load(logw + seq, tn, hd, flags & 2);
    rd.load(dy + seq, tn, hd, flags & 4);
    rr.store(s_r, 1.f);
    rk.store(s_k, 1.f);
    rv.store(s_v, 1.f);
    rw.store(s_cum, kLog2e);
    rd.store(s_dy, 1.f);
  }
  for (int ch = threadIdx.x; ch < HDP; ch += kThreads)
    s_u[ch] = ch < hd ? u[(size_t)n * hd + ch] : 0.f;
  __syncthreads();
  cumsum_columns<HDP, C>(s_cum);
  __syncthreads();

  // M[t, i] = dy_t . v_i; A[s, t] = sum_kk r_s k_t e^{cum_ex_s - cum_t} (s > t)
  for (int idx = threadIdx.x; idx < C * C; idx += kThreads) {
    const int t = idx / C, i = idx % C;
    float m = 0.f, a = 0.f;
    for (int ch = 0; ch < HDP; ch += 4)
      m = dot4(ld4(s_dy + t * LD + ch), ld4(s_v + i * LD + ch), m);
    if (t > i) {
      const float* rt = s_r + t * LD;
      const float* ki = s_k + i * LD;
      const float* ct = s_cum + (t - 1) * LD;
      const float* ci = s_cum + i * LD;
      for (int ch = 0; ch < HDP; ++ch) a = fmaf(rt[ch] * ki[ch], e2(ct[ch] - ci[ch]), a);
    }
    s_M[t * LDA + i] = m;
    s_A[t * LDA + i] = a;
  }
  for (int t = threadIdx.x; t < C; t += kThreads) {
    float acc = 0.f;
    for (int ch = 0; ch < HDP; ++ch) acc = fmaf(s_r[t * LD + ch] * s_u[ch], s_k[t * LD + ch], acc);
    s_bonus[t] = acc;
  }
  asm volatile("cp.async.wait_all;");
  __syncthreads();

  // phase A: dr, with s_x = S_in
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, kk = idx % HDP;
    float sdy = 0.f;
    for (int j = 0; j < HDP; j += 4) sdy = dot4(ld4(s_x + kk * LD + j), ld4(s_dy + t * LD + j), sdy);
    const float cex = t > 0 ? s_cum[(t - 1) * LD + kk] : 0.f;
    const float drin = e2(cex) * sdy;
    float far = 0.f;
    for (int i = 0; i + 1 < t; ++i)
      far = fmaf(s_M[t * LDA + i] * s_k[i * LD + kk], e2(cex - s_cum[i * LD + kk]), far);
    const float near = t > 0 ? s_M[t * LDA + t - 1] * s_k[(t - 1) * LD + kk] : 0.f;
    const float rt = s_r[t * LD + kk];
    const float d = drin + far + near + s_u[kk] * s_k[t * LD + kk] * s_M[t * LDA + t];
    if (t < tn && kk < hd) dr[seq + (size_t)t * hd + kk] = from_f32<T>(d);
    s_a[t * LD + kk] = rt * drin;
    s_rf[t * LD + kk] = rt * far;
  }
  __syncthreads();
  stage_x(gst + slot * HDP * HDP);
  asm volatile("cp.async.wait_all;");
  __syncthreads();

  // phase B: dk, with s_x = G_end
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, kk = idx % HDP;
    float gv = 0.f;
    for (int j = 0; j < HDP; j += 4) gv = dot4(ld4(s_x + kk * LD + j), ld4(s_v + t * LD + j), gv);
    const float ct = s_cum[t * LD + kk];
    const float dkend = e2(s_cum[(C - 1) * LD + kk] - ct) * gv;
    float far = 0.f;
    for (int s = t + 2; s < C; ++s)
      far = fmaf(s_M[s * LDA + t] * s_r[s * LD + kk], e2(s_cum[(s - 1) * LD + kk] - ct), far);
    const float near = t + 1 < C ? s_M[(t + 1) * LDA + t] * s_r[(t + 1) * LD + kk] : 0.f;
    const float kt = s_k[t * LD + kk];
    const float d = dkend + far + near + s_r[t * LD + kk] * s_u[kk] * s_M[t * LDA + t];
    if (t < tn && kk < hd) dk[seq + (size_t)t * hd + kk] = from_f32<T>(d);
    s_b[t * LD + kk] = fmaf(kt, dkend + far, t + 1 < C ? -s_rf[(t + 1) * LD + kk] : 0.f);
  }
  __syncthreads();
  // k decayed to the chunk's end, in place (k is read no more as it was)
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, kk = idx % HDP;
    s_k[t * LD + kk] *= e2(s_cum[(C - 1) * LD + kk] - s_cum[t * LD + kk]);
  }
  __syncthreads();
  // dv
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, jj = idx % HDP;
    float acc = 0.f;
    for (int kk = 0; kk < HDP; ++kk) acc = fmaf(s_k[t * LD + kk], s_x[kk * LD + jj], acc);
    for (int s = t + 1; s < C; ++s) acc = fmaf(s_A[s * LDA + t], s_dy[s * LD + jj], acc);
    acc = fmaf(s_bonus[t], s_dy[t * LD + jj], acc);
    if (t < tn && jj < hd) dv[seq + (size_t)t * hd + jj] = from_f32<T>(acc);
  }

  // phase C: dlogw_t = e^{cum_end} Q + sum_{s>t} a_s + sum_{i<t} b_i, a
  // column a thread
  for (int kk = threadIdx.x; kk < hd; kk += kThreads) {
    float suf = 0.f;
    for (int t = C - 1; t >= 0; --t) {          // a_t -> sum_{s>t} a_s, in place
      const float at = s_a[t * LD + kk];
      s_a[t * LD + kk] = suf;
      suf += at;
    }
    const float base = e2(s_cum[(C - 1) * LD + kk]) * Q[slot * HDP + kk];
    float pre = 0.f;
    for (int t = 0; t < tn; ++t) {
      dlogw[seq + (size_t)t * hd + kk] = base + s_a[t * LD + kk] + pre;
      pre += s_b[t * LD + kk];
    }
  }
}

template <int HDP, int C>
constexpr size_t state_smem() { return (5 * Shape<HDP, C>::TILE + C) * sizeof(float); }
template <int HDP, int C>
constexpr size_t out_smem() { return BwdOutLayout<HDP, C>::END * sizeof(float); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int HDP, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, const void* dy, const void* dS, const void* states,
                   void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0,
                   void* gst, void* wl, void* dup, void* Q, int N, int S, int hd,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_state_kernel<T, HDP, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem<HDP, C>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_bwd_out_kernel<T, HDP, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem<HDP, C>());
  if (err != cudaSuccess) return err;
  constexpr int G = 16 / sizeof(T);
  const int nc = (S + C - 1) / C;
  const int flags = ((hd % G == 0 && aligned16(r) && aligned16(k) && aligned16(v)) ? 1 : 0) |
                    ((hd % 4 == 0 && aligned16(logw)) ? 2 : 0) |
                    ((hd % 4 == 0 && aligned16(dy)) ? 4 : 0);
  const long long blocks = (long long)N * nc;
  const long long pass_blocks = (long long)N * (HDP * HDP / 4 / kThreads);
  if (blocks > 0x7fffffffLL || pass_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* g = static_cast<float*>(gst);
  float* w = static_cast<float*>(wl);
  float* p = static_cast<float*>(dup);
  float* q = static_cast<float*>(Q);
  wkv_bwd_state_kernel<T, HDP, C><<<(unsigned)blocks, kThreads, state_smem<HDP, C>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(dy), g, w, p, S, hd, nc, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_pass_kernel<HDP><<<(unsigned)pass_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(dS), static_cast<const float*>(states), g, w, p, q,
      static_cast<float*>(dstate0), static_cast<float*>(du), hd, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_out_kernel<T, HDP, C><<<(unsigned)blocks, kThreads, out_smem<HDP, C>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<const float*>(dy), static_cast<const float*>(states), g, q,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlogw), S, hd, nc, flags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shape(const void* r, const void* k, const void* v, const void* logw,
                         const void* u, const void* dy, const void* dS, const void* states,
                         void* dr, void* dk, void* dv, void* dlogw, void* du, void* dstate0,
                         void* gst, void* wl, void* dup, void* Q, int N, int S, int hd,
                         cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64, kChunk>(r, k, v, logw, u, dy, dS, states, dr, dk, dv, dlogw, du,
                                 dstate0, gst, wl, dup, Q, N, S, hd, st);
  return launch<T, 128, kChunk>(r, k, v, logw, u, dy, dS, states, dr, dk, dv, dlogw, du,
                                dstate0, gst, wl, dup, Q, N, S, hd, st);
}

}  // namespace

// r, k, v: (N, S, hd), dtype 0 = float32, 1 = bfloat16; logw: (N, S, hd)
// f32; u: (N, hd) f32; dy: (N, S, hd) f32, the gradient of out; dS: (N, hd,
// hd) f32, the gradient of the final state, or null (zero); states: (N, nc,
// HDP, HDP) f32, the forward's scratch after its call (the state entering
// each chunk), with nc = ceil(S / 32) and HDP = 64 for hd <= 64, else 128.
// Writes dr, dk, dv (N, S, hd) of r's dtype, dlogw (N, S, hd), du (N, hd)
// and dstate0 (N, hd, hd) f32, using the f32 scratch gst (N, nc, HDP, HDP),
// wl, dup and Q (N, nc, HDP).  All contiguous on the device; three launches
// on `stream`.  Returns the first launch error (0 when all were accepted).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* dy, const void* dS,
                              const void* states, void* dr, void* dk, void* dv, void* dlogw,
                              void* du, void* dstate0, void* gst, void* wl, void* dup,
                              void* Q, int N, int S, int hd, int dtype, void* stream) {
  if (N <= 0 || S <= 0 || hd <= 0 || hd > 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_shape<float>(r, k, v, logw, u, dy, dS, states, dr, dk, dv, dlogw, du,
                               dstate0, gst, wl, dup, Q, N, S, hd, st);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(r, k, v, logw, u, dy, dS, states, dr, dk, dv, dlogw,
                                       du, dstate0, gst, wl, dup, Q, N, S, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rwkv6_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
