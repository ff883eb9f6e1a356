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
// at least one step's decay.  In f32 that is 1.2e-8 off f64 at logw = -8
// and 2.6e-6 of dlogw's largest value at -1e-6 (N 4, S 512, hd 64; the
// emulation of the sub-block form below in tests/test_torch_train_recurrent.py).
//
// What bounds it on this card: bytes, if anything: r, k, v, logw, dy read
// and dr, dk, dv, dlogw written once, plus the entering states, ~185 MB at
// the training shape (N = 128, S = 512, hd 64, f32), 55 us at 3.35 TB/s.
// The chunked form adds ~1.2 G f32 FMAs there (a (C x hd)(hd x hd) product
// each for dr, dk and dv, M, A and the in-chunk sums), 36 us at the f32 FMA
// peak, and the in-chunk decays on the special-function units.
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
//  * wkv_bwd_out_kernel, one block per (row, chunk), dr, dk, dv and dlogw.
//
// The output kernel, most of a call.  Taking every in-chunk decay directly
// costs C^2 / 2 * hd exponentials three times over (A, dr, dk), and a
// product one output a thread reads both operands from shared memory for
// every FMA.  So:
//  * a thread a (sub-block of kSub = 8 steps, column): NB x HDP threads
//    (256 at hd 64, 512 at 128), each holding its 8 steps' values of dr, dk,
//    dlogw's terms and dv in registers.  Every product is register-tiled
//    that way: 8 rows a thread against one column, the row operand read as
//    a float4 broadcast to the warp (one sub-block), the column operand 16
//    bytes a lane.  f32 FMAs on the CUDA cores, not 3xTF32: the products are
//    ~36 us of the f32 peak against ~65 us of this launch's bytes, and TF32
//    alone misses 1e-3 where |y| ~ 600 (rwkv6_scan.cu's note);
//  * the in-chunk sums by sub-blocks, as the forward's A: a pair within one
//    sub-block takes its decay directly (and the thread of that column
//    adds it to dr, dk and A at once); a pair across sub-blocks splits its
//    decay at the earlier sub-block's last step p, e^{cum_ex_t - cum_i} =
//    e^{cum_ex_t - cum_p} e^{cum_p - cum_i}, both exponents <= 0, so dr's
//    far sum is sum_i M[t, i] kq_i (kq = k decayed to p) times one decay,
//    dk's is kq's decay times sum_s M[s, t] rq_s (rq = r decayed from p),
//    and A across sub-blocks is rq . kq.  ~16 K exponentials a block at hd
//    64 where the first version took ~97 K;
//  * dlogw keeps its term-by-term form: the adjacent pairs (decay 1) stay
//    out of drf and dkf (masked out of the products across sub-blocks), and
//    the suffix and prefix sums over the chunk are each thread's own 8 steps
//    plus the other sub-blocks' totals;
//  * A's terms within a sub-block are summed over a warp's columns by a
//    reduce-scatter (31 shuffles a lane for 28 pairs), then over the warps in
//    order; nothing is added by atomics;
//  * shared memory: tiles that die are reused (kq and rq give way to r o drf,
//    G_end takes S_in's place at hd 128), S_in and, at hd 64, G_end arrive by
//    cp.async while the chunk's own terms are computed: ~108 KB a block at
//    hd 64, two blocks an SM.
// hd is padded to HDP = 64 or 128 as in the forward.
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

// The output kernel works in sub-blocks of kSub steps (the forward's A in
// wkv_out_kernel is built the same way): kPairs pairs (t, i), i < t, within
// one sub-block, numbered t-major: (1,0), (2,0), (2,1), (3,0), ...
constexpr int kSub = 8;
constexpr int kPairs = kSub * (kSub - 1) / 2;
__host__ __device__ constexpr int pair_t(int p) {
  int t = 1;
  while (t * (t + 1) / 2 <= p) ++t;
  return t;
}
__host__ __device__ constexpr int pair_i(int p) { return p - pair_t(p) * (pair_t(p) - 1) / 2; }
static_assert(kPairs <= 32, "a sub-block's pairs share out over a warp's lanes");

// wkv_bwd_out_kernel's shared memory, in floats.  NT = NB x HDP threads, one
// a (sub-block, column).  r, k, v, dy, cum (C x LD each; k becomes k decayed
// to the chunk's end for dv); XS = S_in and XG = G_end (HDP x LD each; at
// HDP 128 G_end takes S_in's place once dr is done); W, rows of LD: kq (the
// first KQ rows: k decayed to the end of its sub-block) and rq (RQ rows: r
// decayed from the end of each earlier sub-block), then rf (C rows) once A
// is built; M (C x LDA, M[t, i] = dy_t . v_i); AT (C x LDA, AT[i, t] = A[t,
// i], zero for t <= i); u (HDP); the bonus (C); ARED, each warp's sums of A
// within its sub-block (NB x HDP); TOT, each sub-block's sums of dlogw's
// terms a and b (2 x NB x HDP).
template <int HDP, int C>
struct BwdOutLayout {
  static constexpr int LD = Shape<HDP, C>::LD, LDA = C + 4, TILE = C * LD;
  static constexpr int NB = C / kSub, NT = NB * HDP;
  static constexpr int KQ = C - kSub, RQ = kSub * NB * (NB - 1) / 2;
  static constexpr bool kOwnG = HDP == 64;         // G_end in a buffer of its own
  static constexpr int WROWS = KQ + RQ > C ? KQ + RQ : C;
  static constexpr int R = 0, K = R + TILE, V = K + TILE, DY = V + TILE, CUM = DY + TILE;
  static constexpr int XS = CUM + TILE, XG = kOwnG ? XS + HDP * LD : XS;
  static constexpr int W = XG + HDP * LD, M = W + WROWS * LD, AT = M + C * LDA;
  static constexpr int U = AT + C * LDA, BONUS = U + HDP, ARED = BONUS + C;
  static constexpr int TOT = ARED + NB * HDP, END = TOT + 2 * NB * HDP;
  // first rq row of sub-block J (rows for its later steps s = kSub (J + 1) .. C - 1)
  static __host__ __device__ constexpr int rq_first(int J) {
    return J * C - kSub * J * (J + 1) / 2;
  }
};

__device__ __forceinline__ void fma8(float (&acc)[kSub], const float4 a, const float4 b, float x) {
  acc[0] = fmaf(a.x, x, acc[0]);
  acc[1] = fmaf(a.y, x, acc[1]);
  acc[2] = fmaf(a.z, x, acc[2]);
  acc[3] = fmaf(a.w, x, acc[3]);
  acc[4] = fmaf(b.x, x, acc[4]);
  acc[5] = fmaf(b.y, x, acc[5]);
  acc[6] = fmaf(b.z, x, acc[6]);
  acc[7] = fmaf(b.w, x, acc[7]);
}

// One block per (row n, chunk c), block index n * nc + c, NB x HDP threads:
// thread (J, kk) takes the kSub steps of sub-block J at column kk.  states:
// the forward's entering states; gst: G_end of each chunk (after the pass);
// Q: the pass's sum_v S_in o G_end; u: (N, hd) f32.  Writes dr, dk, dv (N,
// S, hd) of T and dlogw (N, S, hd) f32.  flags as wkv_bwd_state_kernel's.
template <typename T, int HDP, int C>
__global__ void __launch_bounds__(BwdOutLayout<HDP, C>::NT, 512 / BwdOutLayout<HDP, C>::NT)
wkv_bwd_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ dy,
                   const float* __restrict__ states, const float* __restrict__ gst,
                   const float* __restrict__ Q, T* __restrict__ dr, T* __restrict__ dk,
                   T* __restrict__ dv, float* __restrict__ dlogw, int S, int hd, int nc,
                   int flags) {
  using O = BwdOutLayout<HDP, C>;
  constexpr int LD = O::LD, LDA = O::LDA, NB = O::NB, NT = O::NT;
  static_assert(C % kSub == 0 && NB >= 2 && HDP % 32 == 0, "sub-blocks");
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem + O::R;
  float* s_k = smem + O::K;
  float* s_v = smem + O::V;
  float* s_dy = smem + O::DY;
  float* s_cum = smem + O::CUM;
  float* s_xs = smem + O::XS;
  float* s_xg = smem + O::XG;
  float* s_kq = smem + O::W;
  float* s_rq = s_kq + O::KQ * LD;
  float* s_rf = smem + O::W;
  float* s_M = smem + O::M;
  float* s_at = smem + O::AT;
  float* s_u = smem + O::U;
  float* s_bonus = smem + O::BONUS;
  float* s_ared = smem + O::ARED;
  float* s_tot = smem + O::TOT;

  const int n = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * C, tn = min(C, S - t0);
  const size_t slot = (size_t)n * nc + c;
  const int J = threadIdx.x / HDP, kk = threadIdx.x % HDP, tJ = J * kSub;
  const int lane = threadIdx.x % 32;
  auto stage_x = [&](float* dst, const float* src) {   // (HDP x HDP) f32 by cp.async
    for (int idx = threadIdx.x; idx < HDP * HDP / 4; idx += NT) {
      const int row = idx / (HDP / 4), q = idx % (HDP / 4);
      cp_async16(dst + row * LD + 4 * q, src + (size_t)row * HDP + 4 * q);
    }
    asm volatile("cp.async.commit_group;");
  };
  // S_in (and G_end where it has its own buffer) stream in while the
  // chunk's own terms are computed
  stage_x(s_xs, states + slot * HDP * HDP);
  if constexpr (O::kOwnG) stage_x(s_xg, gst + slot * HDP * HDP);

  const size_t seq = ((size_t)n * S + t0) * hd;
  {
    Rows<T, HDP, C, NT> rr, rk, rv;
    Rows<float, HDP, C, NT> rw, rd;
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
  for (int ch = threadIdx.x; ch < HDP; ch += NT) s_u[ch] = ch < hd ? u[(size_t)n * hd + ch] : 0.f;
  for (int idx = threadIdx.x; idx < C * C; idx += NT) {
    const int i = idx / C, t = idx % C;
    if (t <= i) s_at[i * LDA + t] = 0.f;
  }
  __syncthreads();
  cumsum_columns<HDP, C, NT>(s_cum);
  __syncthreads();

  // ---- phase 1: kq, M, the bonus.  cm[m] = cum at step tJ + m, column kk;
  // cx = cum_ex of step tJ (0 for the chunk's first step)
  float cm[kSub];
#pragma unroll
  for (int m = 0; m < kSub; ++m) cm[m] = s_cum[(tJ + m) * LD + kk];
  const float cx = J > 0 ? s_cum[(tJ - 1) * LD + kk] : 0.f;
  float ek[kSub];                                 // decay from each step to the sub-block's end
  if (J < NB - 1) {
#pragma unroll
    for (int m = 0; m < kSub; ++m) {
      ek[m] = e2(cm[kSub - 1] - cm[m]);
      s_kq[(tJ + m) * LD + kk] = s_k[(tJ + m) * LD + kk] * ek[m];
    }
  }
  // M[t, i] = dy_t . v_i, 4 rows t a thread (read as a broadcast) and one i
  for (int task = threadIdx.x; task < C * C / 4; task += NT) {
    const int t = 4 * (task / C), i = task % C;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < HDP; ch += 4) {
      const float4 x = ld4(s_v + i * LD + ch);
      m0 = dot4(ld4(s_dy + t * LD + ch), x, m0);
      m1 = dot4(ld4(s_dy + (t + 1) * LD + ch), x, m1);
      m2 = dot4(ld4(s_dy + (t + 2) * LD + ch), x, m2);
      m3 = dot4(ld4(s_dy + (t + 3) * LD + ch), x, m3);
    }
    s_M[t * LDA + i] = m0;
    s_M[(t + 1) * LDA + i] = m1;
    s_M[(t + 2) * LDA + i] = m2;
    s_M[(t + 3) * LDA + i] = m3;
  }
  // the bonus (current token) term r_t . (u o k_t): BT lanes a row
  {
    constexpr int BT = NT / C, BCH = HDP / BT;
    static_assert(BT <= 32 && 32 % BT == 0 && BCH % 4 == 0, "bonus lanes");
    const int t = threadIdx.x / BT, ch0 = (threadIdx.x % BT) * BCH;
    float acc = 0.f;
#pragma unroll
    for (int ch = ch0; ch < ch0 + BCH; ch += 4) {
      const float4 a = ld4(s_r + t * LD + ch), b = ld4(s_u + ch), kk4 = ld4(s_k + t * LD + ch);
      acc = fmaf(a.x * b.x, kk4.x, acc);
      acc = fmaf(a.y * b.y, kk4.y, acc);
      acc = fmaf(a.z * b.z, kk4.z, acc);
      acc = fmaf(a.w * b.w, kk4.w, acc);
    }
#pragma unroll
    for (int o = BT / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x % BT == 0) s_bonus[t] = acc;
  }
  __syncthreads();

  // ---- phase 2: the in-chunk sums of dr and dk without the adjacent step
  // (drf, dkf), A within the sub-block, and rq
  float drf[kSub], dkf[kSub];
  {
    float rr[kSub], kr[kSub];
#pragma unroll
    for (int m = 0; m < kSub; ++m) {
      rr[m] = s_r[(tJ + m) * LD + kk];
      kr[m] = s_k[(tJ + m) * LD + kk];
      drf[m] = dkf[m] = 0.f;
    }
    // each pair (t, i) within the sub-block, directly; its term of A at kk
    // goes to ap[pair], the terms of drf and dkf are added in place
    float ap[32];
#pragma unroll
    for (int t = 1; t < kSub; ++t) {
#pragma unroll
      for (int i = 0; i < t; ++i) {
        const float rk = rr[t] * kr[i];
        if (i + 1 == t) {                         // adjacent: decay 1, a near term of dr, dk
          ap[t * (t - 1) / 2 + i] = rk;
          continue;
        }
        const float E = e2(cm[t - 1] - cm[i]);
        const float mti = s_M[(tJ + t) * LDA + tJ + i];
        drf[t] = fmaf(mti * kr[i], E, drf[t]);
        dkf[i] = fmaf(mti * rr[t], E, dkf[i]);
        ap[t * (t - 1) / 2 + i] = rk * E;
      }
    }
#pragma unroll
    for (int p = kPairs; p < 32; ++p) ap[p] = 0.f;
    // summed over the warp's columns by a reduce-scatter: lane L ends with
    // pair L's sum (halving the values a lane holds at each level)
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const bool up = lane & w;
#pragma unroll
      for (int p = 0; p < w; ++p)
        ap[p] = (up ? ap[p + w] : ap[p]) + __shfl_xor_sync(0xffffffffu, up ? ap[p] : ap[p + w], w);
    }
    s_ared[threadIdx.x] = ap[0];

    // dr from every earlier sub-block jp: for i in jp and t in J,
    // e^{cum_ex_t - cum_i} = e^{cum_ex_t - cum_p} e^{cum_p - cum_i} with p
    // jp's last step, both exponents <= 0: sum_i M[t, i] kq_i, then one
    // decay.  The adjacent pair (t = tJ, i = tJ - 1) is left out.
    for (int jp = 0; jp < J; ++jp) {
      const int b0 = jp * kSub;
      float kq[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) kq[i] = s_kq[(b0 + i) * LD + kk];
      const float cp = s_cum[(b0 + kSub - 1) * LD + kk];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float4 m0 = ld4(s_M + (tJ + t) * LDA + b0), m1 = ld4(s_M + (tJ + t) * LDA + b0 + 4);
        const float m7 = (t == 0 && jp == J - 1) ? 0.f : m1.w;
        float acc = m0.x * kq[0];
        acc = fmaf(m0.y, kq[1], acc);
        acc = fmaf(m0.z, kq[2], acc);
        acc = fmaf(m0.w, kq[3], acc);
        acc = fmaf(m1.x, kq[4], acc);
        acc = fmaf(m1.y, kq[5], acc);
        acc = fmaf(m1.z, kq[6], acc);
        acc = fmaf(m7, kq[7], acc);
        drf[t] = fmaf(e2((t > 0 ? cm[t > 0 ? t - 1 : 0] : cx) - cp), acc, drf[t]);
      }
    }
    // dk from every later step s: e^{cum_ex_s - cum_t} = e^{cum_ex_s -
    // cum_p} e^{cum_p - cum_t}, p this sub-block's last step: rq_s = r_s
    // e^{cum_ex_s - cum_p} (kept for A), sum_s M[s, t] rq_s, then ek_t.  The
    // adjacent pair (s = p + 1, t = p) is left out.
    if (J < NB - 1) {
      float dkc[kSub];
#pragma unroll
      for (int m = 0; m < kSub; ++m) dkc[m] = 0.f;
      float* rq = s_rq + (O::rq_first(J) - kSub * (J + 1)) * LD + kk;   // + s * LD: step s
      for (int s = tJ + kSub; s < C; ++s) {
        const float x = s_r[s * LD + kk] * e2(s_cum[(s - 1) * LD + kk] - cm[kSub - 1]);
        rq[s * LD] = x;
        float4 m0 = ld4(s_M + s * LDA + tJ), m1 = ld4(s_M + s * LDA + tJ + 4);
        if (s == tJ + kSub) m1.w = 0.f;
        fma8(dkc, m0, m1, x);
      }
#pragma unroll
      for (int m = 0; m < kSub; ++m) dkf[m] = fmaf(ek[m], dkc[m], dkf[m]);
    }
  }
  __syncthreads();

  // ---- phase 3: A.  Within sub-blocks: the warps' sums, in warp order;
  // across them: rq_J[s] . kq[t], two t a thread
  for (int idx = threadIdx.x; idx < NB * kPairs; idx += NT) {
    const int jb = idx / kPairs, p = idx % kPairs;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < HDP / 32; ++w) a += s_ared[jb * HDP + w * 32 + p];
    s_at[(jb * kSub + pair_i(p)) * LDA + jb * kSub + pair_t(p)] = a;
  }
  for (int task = threadIdx.x; task < O::RQ * kSub / 2; task += NT) {
    const int row = task / (kSub / 2), i2 = 2 * (task % (kSub / 2));
    int jb = 0;
    while (row >= O::rq_first(jb + 1)) ++jb;
    const int s = row - O::rq_first(jb) + kSub * (jb + 1), i = kSub * jb + i2;
    const float* rq = s_rq + row * LD;
    const float* k0 = s_kq + i * LD;
    const float* k1 = k0 + LD;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < HDP; ch += 4) {
      const float4 x = ld4(rq + ch);
      a0 = dot4(x, ld4(k0 + ch), a0);
      a1 = dot4(x, ld4(k1 + ch), a1);
    }
    s_at[i * LDA + s] = a0;
    s_at[(i + 1) * LDA + s] = a1;
  }
  if constexpr (O::kOwnG)
    asm volatile("cp.async.wait_group 1;");       // S_in is here, G_end may not be
  else
    asm volatile("cp.async.wait_group 0;");
  __syncthreads();

  // ---- phase 4: dr_t = e^{cum_ex_t} S_in dy_t + drf_t + near + u k_t M[t, t]
  float acc[kSub];
#pragma unroll
  for (int m = 0; m < kSub; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int j = 0; j < HDP; j += 4) {
    const float4 x = ld4(s_xs + kk * LD + j);
#pragma unroll
    for (int m = 0; m < kSub; ++m) acc[m] = dot4(x, ld4(s_dy + (tJ + m) * LD + j), acc[m]);
  }
  if constexpr (!O::kOwnG) {                      // G_end into S_in's buffer
    __syncthreads();
    stage_x(s_xg, gst + slot * HDP * HDP);
  }
  const float uk = s_u[kk];
  float ta[kSub];                                 // dlogw's a_t = r_t o drin_t
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const int t = tJ + m;
    const float drin = e2(m > 0 ? cm[m > 0 ? m - 1 : 0] : cx) * acc[m];
    const float near = t > 0 ? s_M[t * LDA + t - 1] * s_k[(t - 1) * LD + kk] : 0.f;
    const float d = drin + drf[m] + near + uk * s_k[t * LD + kk] * s_M[t * LDA + t];
    if (t < tn && kk < hd) dr[seq + (size_t)t * hd + kk] = from_f32<T>(d);
    const float rt = s_r[t * LD + kk];
    ta[m] = rt * drin;
    s_rf[t * LD + kk] = rt * drf[m];
  }
  asm volatile("cp.async.wait_all;");
  __syncthreads();

  // ---- phase 5: dk_t = e^{cum_end - cum_t} G_end v_t + dkf_t + near + r_t u
  // M[t, t]; dlogw's b_t; k decayed to the chunk's end, in place
#pragma unroll
  for (int m = 0; m < kSub; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int j = 0; j < HDP; j += 4) {
    const float4 x = ld4(s_xg + kk * LD + j);
#pragma unroll
    for (int m = 0; m < kSub; ++m) acc[m] = dot4(x, ld4(s_v + (tJ + m) * LD + j), acc[m]);
  }
  const float cend = s_cum[(C - 1) * LD + kk];
  float tb[kSub];                                 // dlogw's b_t
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const int t = tJ + m;
    const float kend = e2(cend - cm[m]);
    const float dkend = kend * acc[m];
    const float rt = s_r[t * LD + kk], kt = s_k[t * LD + kk];
    const float near = t + 1 < C ? s_M[(t + 1) * LDA + t] * s_r[(t + 1) * LD + kk] : 0.f;
    const float d = dkend + dkf[m] + near + rt * uk * s_M[t * LDA + t];
    if (t < tn && kk < hd) dk[seq + (size_t)t * hd + kk] = from_f32<T>(d);
    tb[m] = fmaf(kt, dkend + dkf[m], t + 1 < C ? -s_rf[(t + 1) * LD + kk] : 0.f);
    s_k[t * LD + kk] = kt * kend;
    sb += tb[m];
    sa += ta[kSub - 1 - m];
  }
  s_tot[J * HDP + kk] = sa;
  s_tot[(NB + J) * HDP + kk] = sb;
  __syncthreads();

  // ---- phase 6: dv_t = (k_t e^{cum_end - cum_t}) G_end + sum_{s>t} A[s, t]
  // dy_s + bonus_t dy_t, thread (J, jj = kk)
#pragma unroll
  for (int m = 0; m < kSub; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int k2 = 0; k2 < HDP; k2 += 4) {
    const float g0 = s_xg[k2 * LD + kk], g1 = s_xg[(k2 + 1) * LD + kk];
    const float g2 = s_xg[(k2 + 2) * LD + kk], g3 = s_xg[(k2 + 3) * LD + kk];
#pragma unroll
    for (int m = 0; m < kSub; ++m) {
      const float4 x = ld4(s_k + (tJ + m) * LD + k2);
      acc[m] = fmaf(x.w, g3, fmaf(x.z, g2, fmaf(x.y, g1, fmaf(x.x, g0, acc[m]))));
    }
  }
  for (int s = tJ; s < C; s += 4) {               // AT[t, s] is zero for s <= t
    const float d0 = s_dy[s * LD + kk], d1 = s_dy[(s + 1) * LD + kk];
    const float d2 = s_dy[(s + 2) * LD + kk], d3 = s_dy[(s + 3) * LD + kk];
#pragma unroll
    for (int m = 0; m < kSub; ++m) {
      const float4 x = ld4(s_at + (tJ + m) * LDA + s);
      acc[m] = fmaf(x.w, d3, fmaf(x.z, d2, fmaf(x.y, d1, fmaf(x.x, d0, acc[m]))));
    }
  }
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const int t = tJ + m;
    const float x = fmaf(s_bonus[t], s_dy[t * LD + kk], acc[m]);
    if (t < tn && kk < hd) dv[seq + (size_t)t * hd + kk] = from_f32<T>(x);
  }

  // ---- phase 7: dlogw_t = e^{cum_end} Q + sum_{s>t} a_s + sum_{i<t} b_i,
  // the sums over other sub-blocks from their totals
  float suf = 0.f, pre = 0.f;
  for (int jb = NB - 1; jb > J; --jb) suf += s_tot[jb * HDP + kk];
  for (int jb = 0; jb < J; ++jb) pre += s_tot[(NB + jb) * HDP + kk];
  const float base = e2(cend) * Q[slot * HDP + kk];
  float sfx[kSub];
#pragma unroll
  for (int m = kSub - 1; m >= 0; --m) {
    sfx[m] = suf;
    suf += ta[m];
  }
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const int t = tJ + m;
    if (t < tn && kk < hd) dlogw[seq + (size_t)t * hd + kk] = base + sfx[m] + pre;
    pre += tb[m];
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
  wkv_bwd_out_kernel<T, HDP, C><<<(unsigned)blocks, BwdOutLayout<HDP, C>::NT, out_smem<HDP, C>(),
                                   stream>>>(
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
