// RWKV-6 WKV recurrence for Hopper (sm_90a), over N = batch * heads rows:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// with w_t = exp(logw_t) and a carried (hd x hd) f32 state per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (_wkv_kernel at :23, launched by rwkv6_scan at :73).  Both compute the
// recurrence in chunks of C steps in closed form (kernel.py:23-69).  Per
// chunk, with cum / cum_ex the inclusive / exclusive cumulative log-decays
// and wlast = cum[C-1]:
//   y[t]  = sum_{i<t} A[t,i] v[i] + (r[t] u k[t]) v[t] + (r[t] exp(cum_ex[t])) S_in,
//   A[t,i] = sum_k r[t,k] k[i,k] exp(min(cum_ex[t,k] - cum[i,k], 0)),
//   S_out = diag(exp(wlast)) S_in + (k exp(wlast - cum))^T v.
// Every exponent is <= 0: nothing is factored into exp(a) * exp(-b), which
// overflows f32 within a chunk when logw reaches -8.
//
// What bounds it on this card: bytes.  It must read r, k, v, logw once and
// write y once (plus the state in and out): 16 FLOPs per f32 element read in
// the sequential form, under the ~20 FLOPs per byte where f32 compute binds.
// The chunked form adds exponentials on the special-function units: C^2 / 2
// * hd a chunk taken directly (~8 M at N = 32, S = 256: a few us at 16 a
// clock an SM), ~2.3x fewer with the sub-blocks of wkv_out_kernel.
// What held the sequential kernel back was latency: S dependent steps per
// row on N x 2 blocks (64 at the main path's N = 32) of a 132-SM card.
//
// What the design does about it: the TPU kernel's sequential grid axis over
// chunks becomes parallel blocks, and only an nc-step chain per row is left.
// Three launches a call:
//  * wkv_state_kernel, one block per (row, chunk), all chunks at once: stages
//    the chunk's k, v, logw in shared memory (16-byte loads, all of a
//    thread's in flight before any is stored; masked past S and past hd,
//    never padded by a copy), takes the cumulative log-decays (in log2
//    units, so every exponential is one ex2; a scan by shuffles), and writes
//    the chunk's own state contribution dS = (k exp(wlast - cum))^T v and its
//    decay wlast to scratch;
//  * wkv_pass_kernel walks each row's nc chunks, S_c = exp(wlast_c) o S_{c-1}
//    + dS_c, one float4 of the state a thread over HDP^2 / 1024 blocks a
//    row, the next 8 chunks' loads in flight; it overwrites dS_c with the
//    state that enters chunk c and writes the final state;
//  * wkv_out_kernel, one block per (row, chunk): stages r, k, v, logw again
//    while the chunk's entering state streams into shared memory by
//    cp.async, computes the lower triangle of A by sub-blocks of 8 steps
//    (pairs within a sub-block directly; the rest as products of r and k
//    each decayed towards the sub-block's last step, both exponents <= 0),
//    the bonus r u k, then y = (r exp(cum_ex)) S_in + A v + bonus v from
//    register tiles, and stores y once.
//  * The products ((C x hd)(hd x hd), (hd x C)(C x hd), (C x C)(C x hd))
//    run as f32 FMAs on the CUDA cores from shared memory, not on tensor
//    cores: TF32 keeps ~3 decimal digits, and with outputs of 1-500 (a state
//    that grows when logw ~ 0) it misses the reference's atol of 1e-3; 3xTF32
//    would triple the products for a kernel whose products are not what
//    bounds it (~70 M FMAs at the main path's shape: ~2 us of f32 peak).
//  * hd is padded to HDP = 64 or 128 in shared memory and scratch (padded
//    channels are zero); C = 32 steps a chunk (16 ran ~10% slower on an H100).
// Known limits: a call stays ~7x its bytes bound at the main path's shape;
// half of it is the output kernel's chain of phases at ~2 blocks an SM.
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

// One block per (row n, chunk c), block index n * nc + c: the chunk's own
// state contribution dS and its decay wlast (log2 units).
// k, v: (N, S, hd) of T; logw: (N, S, hd) f32; states: (N, nc, HDP, HDP)
// f32 scratch, dS_c written to slot c; wlast: (N, nc, HDP) f32 scratch.
// flags: bit 0 k/v vector-loadable, bit 1 logw.
template <typename T, int HDP, int C>
__global__ void __launch_bounds__(kThreads)
wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ logw, float* __restrict__ states,
                 float* __restrict__ wlast, int S, int hd, int nc, int flags) {
  using L = Shape<HDP, C>;
  constexpr int LD = L::LD;
  constexpr int TK = HDP / 16, TJ = HDP / 16;     // dS tile a thread
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + L::TILE;
  float* s_cum = s_v + L::TILE;

  const int n = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * C, tn = min(C, S - t0);
  const size_t seq = ((size_t)n * S + t0) * hd;
  {
    Rows<T, HDP, C> rk, rv;
    Rows<float, HDP, C> rw;
    rk.load(k + seq, tn, hd, flags & 1);
    rv.load(v + seq, tn, hd, flags & 1);
    rw.load(logw + seq, tn, hd, flags & 2);
    rk.store(s_k, 1.f);
    rv.store(s_v, 1.f);
    rw.store(s_cum, kLog2e);
  }
  __syncthreads();
  cumsum_columns<HDP, C>(s_cum);
  __syncthreads();

  // k decayed from its step to the chunk's end: exponent wlast - cum <= 0
  float* wl = wlast + ((size_t)n * nc + c) * HDP;
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, ch = idx % HDP;
    const float last = s_cum[(C - 1) * LD + ch];
    s_k[t * LD + ch] *= exp2_approx(fminf(last - s_cum[t * LD + ch], 0.f));
    if (t == 0) wl[ch] = last;
  }
  __syncthreads();

  // dS[kk, j] = sum_i kd[i, kk] v[i, j], a TK x TJ tile a thread
  const int k0 = (threadIdx.x / 16) * TK, j0 = (threadIdx.x % 16) * TJ;
  float acc[TK][TJ];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int b = 0; b < TJ; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int i = 0; i < C; ++i) {
    float kk[TK], vv[TJ];
#pragma unroll
    for (int q = 0; q < TK / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(s_k + i * LD + k0 + 4 * q);
      kk[4 * q] = x.x; kk[4 * q + 1] = x.y; kk[4 * q + 2] = x.z; kk[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < TJ / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(s_v + i * LD + j0 + 4 * q);
      vv[4 * q] = x.x; vv[4 * q + 1] = x.y; vv[4 * q + 2] = x.z; vv[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int a = 0; a < TK; ++a)
#pragma unroll
      for (int b = 0; b < TJ; ++b) acc[a][b] = fmaf(kk[a], vv[b], acc[a][b]);
  }
  float* ds = states + ((size_t)n * nc + c) * HDP * HDP;
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int q = 0; q < TJ / 4; ++q)
      *reinterpret_cast<float4*>(ds + (size_t)(k0 + a) * HDP + j0 + 4 * q) =
          make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
}

// The pass over each row's chunks, S_c = exp(wlast_c) o S_{c-1} + dS_c:
// one float4 of the state a thread, SL = HDP^2 / 4 / kThreads blocks a row
// (block index n * SL + slice), the next kAhead chunks' dS and decays in
// flight.  Slot c of states gets the state that enters chunk c in place of
// dS_c; state_out the final state.  state0, state_out: (N, hd, hd) f32.
constexpr int kAhead = 8;

template <int HDP>
__global__ void __launch_bounds__(kThreads)
wkv_pass_kernel(const float* __restrict__ state0, float* __restrict__ state_out,
                float* __restrict__ states, const float* __restrict__ wlast, int hd,
                int nc) {
  constexpr int SL = HDP * HDP / 4 / kThreads;
  const int n = blockIdx.x / SL;
  const int f = (blockIdx.x % SL) * kThreads + threadIdx.x;   // float4 index
  const int kk = f * 4 / HDP, j = f * 4 % HDP;
  float x[4];
  const float* s0 = state0 + (size_t)n * hd * hd + (size_t)kk * hd + j;
#pragma unroll
  for (int m = 0; m < 4; ++m) x[m] = (kk < hd && j + m < hd) ? s0[m] : 0.f;
  float4 st = make_float4(x[0], x[1], x[2], x[3]);

  float4* slots = reinterpret_cast<float4*>(states + (size_t)n * nc * HDP * HDP) + f;
  const float* wl = wlast + (size_t)n * nc * HDP + kk;
  constexpr int kStride = HDP * HDP / 4;           // float4s from one slot to the next
  float4 dq[kAhead];
  float wq[kAhead];
#pragma unroll
  for (int p = 0; p < kAhead; ++p) {
    if (p < nc) {
      dq[p] = slots[(size_t)p * kStride];
      wq[p] = wl[(size_t)p * HDP];
    }
  }
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
#pragma unroll
    for (int p = 0; p < kAhead; ++p) {
      const int cc = c0 + p;
      if (cc >= nc) break;
      const float4 d = dq[p];
      const float w = exp2_approx(fminf(wq[p], 0.f));
      if (cc + kAhead < nc) {
        dq[p] = slots[(size_t)(cc + kAhead) * kStride];
        wq[p] = wl[(size_t)(cc + kAhead) * HDP];
      }
      slots[(size_t)cc * kStride] = st;           // the state entering chunk cc
      st = make_float4(fmaf(w, st.x, d.x), fmaf(w, st.y, d.y), fmaf(w, st.z, d.z),
                       fmaf(w, st.w, d.w));
    }
  }
  float* so = state_out + (size_t)n * hd * hd + (size_t)kk * hd + j;
  const float y[4] = {st.x, st.y, st.z, st.w};
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (kk < hd && j + m < hd) so[m] = y[m];
}

// (t, i) of lower-triangle pair p (i < t), pairs ordered by t then i
__device__ __forceinline__ void pair_of(int p, int& t, int& i) {
  t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
  while (t * (t - 1) / 2 > p) --t;
  while ((t + 1) * t / 2 <= p) ++t;
  i = p - t * (t - 1) / 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// wkv_out_kernel's shared memory, in floats: r, k, v, cum (C x LD each), the
// entering state (HDP x LD), A (C x LDA), u (HDP), the bonus (C) and rq
// (RQ rows of LD: r decayed to the end of each earlier sub-block)
template <int HDP, int C>
struct OutLayout {
  static constexpr int LD = Shape<HDP, C>::LD, LDA = C + 4;
  static constexpr int SB = 8, NB = C / SB;       // sub-blocks of A
  static constexpr int RQ = SB * NB * (NB - 1) / 2;
  static constexpr int R = 0, K = R + C * LD, V = K + C * LD, CUM = V + C * LD;
  static constexpr int ST = CUM + C * LD, A = ST + HDP * LD, U = A + C * LDA;
  static constexpr int BONUS = U + HDP, RQS = BONUS + C, END = RQS + RQ * LD;
};

// One block per (row n, chunk c), block index n * nc + c; states holds the
// state entering each chunk (wkv_pass_kernel's output).  r: (N, S, hd) of
// T; u: (N, hd) f32; out: (N, S, hd) f32.  flags: bit 0 r/k/v vector-
// loadable, bit 1 logw, bit 2 out float4-storable.
//
// A (t > i) in sub-blocks of SB = 8 steps.  Pairs within one sub-block take
// their exponentials directly.  For i in sub-block J and t after it, with p
// = the last step of J (i <= p < t):
//   exp(cum[t-1] - cum[i]) = exp(cum[t-1] - cum[p]) * exp(cum[p] - cum[i]),
// both exponents <= 0, so A[t, J] = rq_J[t] . kq_J[i] is a small product of
// r and k each decayed towards p (C * hd exponentials a sub-block, not
// SB * C * hd).
template <typename T, int HDP, int C>
__global__ void __launch_bounds__(kThreads)
wkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ states,
               float* __restrict__ out, int S, int hd, int nc, int flags) {
  using O = OutLayout<HDP, C>;
  constexpr int LD = O::LD, LDA = O::LDA, SB = O::SB, NB = O::NB;
  constexpr int JQ = HDP / 4;                     // column quads
  constexpr int TT = C * JQ / kThreads;           // rows of y a thread
  constexpr int DIAG = SB * (SB - 1) / 2;         // pairs within a sub-block
  constexpr int BT = kThreads / C, BCH = HDP / BT;  // bonus: threads a row, channels a thread
  static_assert(TT >= 1 && C * JQ == TT * kThreads, "tile does not cover the chunk");
  static_assert(BT <= 32 && 32 % BT == 0 && BCH % 4 == 0, "bonus lanes");
  static_assert(C % SB == 0 && NB * DIAG <= kThreads, "sub-blocks");
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem + O::R;
  float* s_k = smem + O::K;
  float* s_v = smem + O::V;
  float* s_cum = smem + O::CUM;
  float* s_S = smem + O::ST;
  float* s_A = smem + O::A;
  float* s_u = smem + O::U;
  float* s_bonus = smem + O::BONUS;
  float* s_rq = smem + O::RQS;

  const int n = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * C, tn = min(C, S - t0);

  // the entering state streams in while the chunk's own terms are computed
  const float* src = states + ((size_t)n * nc + c) * HDP * HDP;
  for (int idx = threadIdx.x; idx < HDP * HDP / 4; idx += kThreads) {
    const int kk = idx / JQ, q = idx % JQ;
    cp_async16(s_S + kk * LD + 4 * q, src + (size_t)kk * HDP + 4 * q);
  }
  asm volatile("cp.async.commit_group;");

  const size_t seq = ((size_t)n * S + t0) * hd;
  {
    Rows<T, HDP, C> rr, rk, rv;
    Rows<float, HDP, C> rw;
    rr.load(r + seq, tn, hd, flags & 1);
    rk.load(k + seq, tn, hd, flags & 1);
    rv.load(v + seq, tn, hd, flags & 1);
    rw.load(logw + seq, tn, hd, flags & 2);
    rr.store(s_r, 1.f);
    rk.store(s_k, 1.f);
    rv.store(s_v, 1.f);
    rw.store(s_cum, kLog2e);
  }
  for (int ch = threadIdx.x; ch < HDP; ch += kThreads)
    s_u[ch] = ch < hd ? u[(size_t)n * hd + ch] : 0.f;
  for (int idx = threadIdx.x; idx < C * C; idx += kThreads) {
    const int t = idx / C, i = idx % C;
    if (i >= t) s_A[t * LDA + i] = 0.f;
  }
  __syncthreads();
  cumsum_columns<HDP, C>(s_cum);
  __syncthreads();

  // pairs within a sub-block, directly; cum_ex[t] = cum[t - 1]
  if (threadIdx.x < NB * DIAG) {
    int t, i;
    pair_of(threadIdx.x % DIAG, t, i);
    t += SB * (threadIdx.x / DIAG);
    i += SB * (threadIdx.x / DIAG);
    const float* rt = s_r + t * LD;
    const float* ct = s_cum + (t - 1) * LD;
    const float* ki = s_k + i * LD;
    const float* ci = s_cum + i * LD;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < HDP; ch += 4) {
      const float4 a = *reinterpret_cast<const float4*>(rt + ch);
      const float4 b = *reinterpret_cast<const float4*>(ct + ch);
      const float4 kk = *reinterpret_cast<const float4*>(ki + ch);
      const float4 d = *reinterpret_cast<const float4*>(ci + ch);
      acc0 = fmaf(a.x * kk.x, exp2_approx(fminf(b.x - d.x, 0.f)), acc0);
      acc1 = fmaf(a.y * kk.y, exp2_approx(fminf(b.y - d.y, 0.f)), acc1);
      acc0 = fmaf(a.z * kk.z, exp2_approx(fminf(b.z - d.z, 0.f)), acc0);
      acc1 = fmaf(a.w * kk.w, exp2_approx(fminf(b.w - d.w, 0.f)), acc1);
    }
    s_A[t * LDA + i] = acc0 + acc1;
  }
  // rq_J[t] = r[t] exp(cum[t-1] - cum[p_J]) for each sub-block J and each t
  // after it: RQ rows, J by J, a warp a row
  for (int row = threadIdx.x / 32; row < O::RQ; row += kThreads / 32) {
    int J = 0, first = 0;                       // first RQ row of sub-block J
#pragma unroll
    for (int jj = 0; jj + 1 < NB; ++jj) {
      const int rows = C - SB * (jj + 1);
      if (J == jj && jj + 1 < NB - 1 && row >= first + rows) { first += rows; J = jj + 1; }
    }
    const int t = row - first + SB * (J + 1), pj = SB * J + SB - 1;
#pragma unroll
    for (int ch = threadIdx.x % 32; ch < HDP; ch += 32)
      s_rq[row * LD + ch] = s_r[t * LD + ch] *
          exp2_approx(fminf(s_cum[(t - 1) * LD + ch] - s_cum[pj * LD + ch], 0.f));
  }
  // the bonus (current token) term r[t] . (u o k[t]): BT lanes a row
  {
    const int t = threadIdx.x / BT, ch0 = (threadIdx.x % BT) * BCH;
    float acc = 0.f;
#pragma unroll
    for (int ch = ch0; ch < ch0 + BCH; ch += 4) {
      const float4 a = *reinterpret_cast<const float4*>(s_r + t * LD + ch);
      const float4 b = *reinterpret_cast<const float4*>(s_u + ch);
      const float4 kk = *reinterpret_cast<const float4*>(s_k + t * LD + ch);
      acc = fmaf(a.x * b.x, kk.x, acc);
      acc = fmaf(a.y * b.y, kk.y, acc);
      acc = fmaf(a.z * b.z, kk.z, acc);
      acc = fmaf(a.w * b.w, kk.w, acc);
    }
#pragma unroll
    for (int o = BT / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x % BT == 0) s_bonus[t] = acc;
  }
  __syncthreads();
  // in place, now that the raw r and k are read: kq_J[i] = k[i] exp(cum[p_J]
  // - cum[i]) for i in every sub-block but the last, and r decayed from the
  // chunk's start for the read-out, exponent cum_ex <= 0
  for (int idx = threadIdx.x; idx < C * HDP; idx += kThreads) {
    const int t = idx / HDP, ch = idx % HDP;
    const float ct = s_cum[t * LD + ch];
    if (t < C - SB) {
      const int pj = (t / SB) * SB + SB - 1;
      s_k[t * LD + ch] *= exp2_approx(fminf(s_cum[pj * LD + ch] - ct, 0.f));
    }
    if (t > 0) s_r[t * LD + ch] *= exp2_approx(fminf(s_cum[(t - 1) * LD + ch], 0.f));
  }
  __syncthreads();
  // A[t, i] for i in sub-block J < t's: rq_J[t] . kq_J[i], two i a thread
  for (int task = threadIdx.x; task < O::RQ * SB / 2; task += kThreads) {
    const int row = task / (SB / 2), i2 = 2 * (task % (SB / 2));
    int J = 0, first = 0;
#pragma unroll
    for (int jj = 0; jj + 1 < NB; ++jj) {
      const int rows = C - SB * (jj + 1);
      if (J == jj && jj + 1 < NB - 1 && row >= first + rows) { first += rows; J = jj + 1; }
    }
    const int t = row - first + SB * (J + 1), i = SB * J + i2;
    const float* rq = s_rq + row * LD;
    const float* k0 = s_k + i * LD;
    const float* k1 = k0 + LD;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < HDP; ch += 4) {
      const float4 x = *reinterpret_cast<const float4*>(rq + ch);
      const float4 y0 = *reinterpret_cast<const float4*>(k0 + ch);
      const float4 y1 = *reinterpret_cast<const float4*>(k1 + ch);
      a0 = fmaf(x.x, y0.x, fmaf(x.y, y0.y, fmaf(x.z, y0.z, fmaf(x.w, y0.w, a0))));
      a1 = fmaf(x.x, y1.x, fmaf(x.y, y1.y, fmaf(x.z, y1.z, fmaf(x.w, y1.w, a1))));
    }
    s_A[t * LDA + i] = a0;
    s_A[t * LDA + i + 1] = a1;
  }
  asm volatile("cp.async.wait_all;");
  __syncthreads();

  // y[t, j0:j0+4] for TT rows t: (r exp(cum_ex)) S_in + A v + bonus v, each
  // row's operand read 4 at a time
  const int jq = threadIdx.x % JQ, tg = threadIdx.x / JQ, j0 = 4 * jq;
  float4 acc[TT];
#pragma unroll
  for (int a = 0; a < TT; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int kk = 0; kk < HDP; kk += 4) {
    float4 x[TT];
#pragma unroll
    for (int a = 0; a < TT; ++a)
      x[a] = *reinterpret_cast<const float4*>(s_r + (tg * TT + a) * LD + kk);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 sv = *reinterpret_cast<const float4*>(s_S + (kk + m) * LD + j0);
#pragma unroll
      for (int a = 0; a < TT; ++a) {
        const float xm = m == 0 ? x[a].x : m == 1 ? x[a].y : m == 2 ? x[a].z : x[a].w;
        acc[a].x = fmaf(xm, sv.x, acc[a].x);
        acc[a].y = fmaf(xm, sv.y, acc[a].y);
        acc[a].z = fmaf(xm, sv.z, acc[a].z);
        acc[a].w = fmaf(xm, sv.w, acc[a].w);
      }
    }
  }
#pragma unroll 2
  for (int i = 0; i < C; i += 4) {
    float4 x[TT];
#pragma unroll
    for (int a = 0; a < TT; ++a)
      x[a] = *reinterpret_cast<const float4*>(s_A + (tg * TT + a) * LDA + i);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 vv = *reinterpret_cast<const float4*>(s_v + (i + m) * LD + j0);
#pragma unroll
      for (int a = 0; a < TT; ++a) {
        const float xm = m == 0 ? x[a].x : m == 1 ? x[a].y : m == 2 ? x[a].z : x[a].w;
        acc[a].x = fmaf(xm, vv.x, acc[a].x);
        acc[a].y = fmaf(xm, vv.y, acc[a].y);
        acc[a].z = fmaf(xm, vv.z, acc[a].z);
        acc[a].w = fmaf(xm, vv.w, acc[a].w);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TT; ++a) {
    const int t = tg * TT + a;
    if (t >= tn) continue;
    const float4 vv = *reinterpret_cast<const float4*>(s_v + t * LD + j0);
    const float b = s_bonus[t];
    const float y[4] = {fmaf(b, vv.x, acc[a].x), fmaf(b, vv.y, acc[a].y),
                        fmaf(b, vv.z, acc[a].z), fmaf(b, vv.w, acc[a].w)};
    float* dst = out + seq + (size_t)t * hd + j0;
    if ((flags & 4) && j0 + 4 <= hd) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (j0 + m < hd) dst[m] = y[m];
    }
  }
}

template <int HDP, int C>
constexpr size_t state_smem() { return 3 * Shape<HDP, C>::TILE * sizeof(float); }
template <int HDP, int C>
constexpr size_t out_smem() { return OutLayout<HDP, C>::END * sizeof(float); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int HDP, int C>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, const void* state0, void* out, void* state_out,
                   void* states, void* wlast, int N, int S, int hd, cudaStream_t stream) {
  // shared memory above 48 KB needs an opt-in, which belongs to the current
  // device: set on every call (it is cheap), so any device and thread has it
  cudaError_t err = cudaFuncSetAttribute(wkv_state_kernel<T, HDP, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)state_smem<HDP, C>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_out_kernel<T, HDP, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem<HDP, C>());
  if (err != cudaSuccess) return err;
  constexpr int G = 16 / sizeof(T);
  const int nc = (S + C - 1) / C;
  const int flags = ((hd % G == 0 && aligned16(r) && aligned16(k) && aligned16(v)) ? 1 : 0) |
                    ((hd % 4 == 0 && aligned16(logw)) ? 2 : 0) |
                    ((hd % 4 == 0 && aligned16(out)) ? 4 : 0);
  const long long blocks = (long long)N * nc;
  const long long pass_blocks = (long long)N * (HDP * HDP / 4 / kThreads);
  if (blocks > 0x7fffffffLL || pass_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* st = static_cast<float*>(states);
  float* wl = static_cast<float*>(wlast);
  wkv_state_kernel<T, HDP, C><<<(unsigned)blocks, kThreads, state_smem<HDP, C>(), stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(logw), st,
      wl, S, hd, nc, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_pass_kernel<HDP><<<(unsigned)pass_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(state0), static_cast<float*>(state_out), st, wl, hd, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_out_kernel<T, HDP, C><<<(unsigned)blocks, kThreads, out_smem<HDP, C>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u), st,
      static_cast<float*>(out), S, hd, nc, flags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shape(const void* r, const void* k, const void* v, const void* logw,
                         const void* u, const void* state0, void* out, void* state_out,
                         void* states, void* wlast, int N, int S, int hd,
                         cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64, kChunk>(r, k, v, logw, u, state0, out, state_out, states, wlast, N,
                                 S, hd, st);
  return launch<T, 128, kChunk>(r, k, v, logw, u, state0, out, state_out, states, wlast, N, S,
                                hd, st);
}

}  // namespace

// r, k, v: (N, S, hd), dtype 0 = float32, 1 = bfloat16; logw: (N, S, hd)
// f32; u: (N, hd) f32; state0: (N, hd, hd) f32; out: (N, S, hd) f32;
// state_out: (N, hd, hd) f32; states: (N, nc, HDP, HDP) f32 and wlast: (N,
// nc, HDP) f32 scratch, with nc = ceil(S / 32) and HDP = 64 for hd <= 64,
// else 128; all contiguous on the device.  Three launches
// on `stream`.  Returns the first launch error (0 when all were accepted).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* state0,
                          void* out, void* state_out, void* states, void* wlast,
                          int N, int S, int hd, int dtype, void* stream) {
  if (N <= 0 || S <= 0 || hd <= 0 || hd > 128) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_shape<float>(r, k, v, logw, u, state0, out, state_out, states, wlast, N, S,
                               hd, st);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(r, k, v, logw, u, state0, out, state_out, states,
                                       wlast, N, S, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
