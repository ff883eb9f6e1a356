// Absorbed multi-head latent attention (MLA, DeepSeek-V2) decode for Hopper
// (sm_90a): one query token per (batch row, head) against the compressed
// latent cache, each batch row at its own length, split over the KV axis.
//
// No TPU kernel to replace: the reference computes this function in XLA
// einsums (src/repro/models/attention.py, apply_mla's decode branch, from
// q_abs to ctx).  For query head h of row b:
//
//   s[t] = (q_abs[b, h] . ckv[b, t] + q_rope[b, h] . krope[b, t]) * scale
//   p    = softmax(s over t < kv_len[b])
//   ctx  = sum_t p[t] ckv[b, t]
//
// in f32, the output in the input dtype.  All heads of a row read the same
// latent row (L + R values: 576 at kv_lora_rank 512, rope 64) and the values
// are the first L columns of the keys, the latent itself: that is MLA's
// memory saving (1,152 bytes a token a layer in bf16 against 65,536 for the
// same 128 heads in GQA), and what the kernel is built around.
//
// What bounds it on this card.  A row reads kv_len * (L + R) cache values
// once and does 2 * H * kv_len * (2L + R) FLOPs on them: with H = 128 about
// 240 FLOPs per bf16 byte (480 per f32 byte of 4), above the CUDA cores'
// ~20 (67 TFLOP/s over 3.35 TB/s), so on the CUDA cores it is bound by the
// FMA rate, not by the cache's bytes.  (On the tensor cores, bf16 at 989
// TFLOP/s, the bytes would bind: later work.)
//
// What the design does about it:
//  * a block holds 16 query heads of one row and loads each latent tile (32
//    keys by L + R) into shared memory once for all of them, by cp.async,
//    two tiles in flight; the grid's fastest axis is the head chunk, so the
//    chunks of one (row, split) read the same tile from L2 at about the
//    same time;
//  * scores: a lane per key, a warp per every 8th 16-byte piece of the
//    row; each piece of K is loaded once and multiplied by the 16 heads' Q
//    (f32 in shared memory, read as broadcasts), the 8 warps' partial sums
//    added in shared memory.  P V: a thread per two output columns, its 32
//    accumulators (16 heads x 2) in registers, P read as broadcasts;
//  * the KV axis is split over nsplit blocks per (row, head chunk), each
//    row's valid keys shared out over them in whole tiles (the split
//    follows kv_len[b], read on the device: a short row does not leave most
//    blocks without work); a block reads no key at or past kv_len[b];
//  * the splits' (m, l, acc) partials go to a workspace; the last block of
//    a (row, head chunk) to finish, found with an atomic counter that it
//    then resets, merges them in split order, so a call is one launch and
//    its result does not depend on block order.  With one split a block
//    writes the output itself.
// (m, l, acc) are f32; m starts at -1e30 and the output is acc / max(l,
// 1e-30), so a row with kv_len 0 gives 0.  In bf16 each probability is
// rounded to bf16 before the P V product, as the reference rounds its
// probabilities to the compute dtype; the kernel rounds exp(s - m) against
// the running max m, the reference the normalised probability, so the two
// round different numbers (the sum l is taken unrounded).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kHeads = 16;           // query heads a block holds
constexpr int kKeys = 32;            // keys a tile: a warp's lanes
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxL = 2 * kThreads;  // latent width: two output columns a thread
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// a probability as the P V product takes it: rounded to bf16 in the bf16 kernel
__device__ __forceinline__ float operand(float p, float) { return p; }
__device__ __forceinline__ float operand(float p, bf16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 16 bytes of a row (4 floats or 8 bf16) as f32
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* x) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  // a bf16 is the high half of the f32 with the same value
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
  x[4] = __uint_as_float(t.z << 16); x[5] = __uint_as_float(t.z & 0xffff0000u);
  x[6] = __uint_as_float(t.w << 16); x[7] = __uint_as_float(t.w & 0xffff0000u);
}
// two consecutive elements as f32
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x; b = t.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x; b = t.y;
}

// Shared memory of a block: Q [16][D] f32, the warps' partial scores [8][16]
// [32] f32, P [32][16] f32, (m, l, corr) [16] each, then two tiles of 32
// latent rows [ckv (L) | krope (R)] in T, each row padded by 16 bytes so
// that lanes reading different rows hit different banks.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kHeads * D + kWarps * kHeads * kKeys + kKeys * kHeads +
                          3 * kHeads) +
         sizeof(T) * 2 * kKeys * (size_t)(D + 16 / sizeof(T));
}

// One block: head chunk blockIdx.x (heads [16 x, 16 x + 16) of H), KV
// split blockIdx.y, batch row blockIdx.z.  q_abs, out: (B, H, L); q_rope:
// (B, H, R); ckv: (B, T, L); krope: (B, T, R); part_ml: (B * H, nsplit, 2);
// part_acc: (B * H, nsplit, L); counters: one per (row, head chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const T* __restrict__ q_abs, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ krope,
                  const int* __restrict__ kv_len, T* __restrict__ out, float* part_ml,
                  float* part_acc, int* __restrict__ counters, int H, int S, int L, int R,
                  int nsplit, float scale) {
  constexpr int CH = 16 / sizeof(T);  // elements of a 16-byte piece
  const int D = L + R, ldk = D + CH, pl = L / CH, pieces = D / CH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kHeads][D]
  float* Sp = Qs + kHeads * D;                 // [kWarps][kHeads][kKeys]
  float* Ps = Sp + kWarps * kHeads * kKeys;    // [kKeys][kHeads]
  float* ms = Ps + kKeys * kHeads;             // running max of each head
  float* ls = ms + kHeads;                     // running sum
  float* cs = ls + kHeads;                     // this tile's correction
  T* Kt = reinterpret_cast<T*>(cs + kHeads);   // [2][kKeys][ldk]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hc = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int h0 = hc * kHeads, nh = min(kHeads, H - h0);
  // this row's valid keys, shared out over the splits in whole tiles
  const int len = min(max(kv_len[b], 0), S);
  const int per = ((len + kKeys - 1) / kKeys + nsplit - 1) / nsplit * kKeys;
  const int start = min(len, split * per), end = min(len, start + per);
  const int ntiles = (end - start + kKeys - 1) / kKeys;
  const T* ckv_b = ckv + (size_t)b * S * L;
  const T* kr_b = krope + (size_t)b * S * R;

  auto issue = [&](int t, int stage) {  // tile t of this split, its valid rows only
    T* dst = Kt + (size_t)stage * kKeys * ldk;
    const int k0 = start + t * kKeys, rows = min(kKeys, end - k0);
    for (int i = tid; i < rows * pieces; i += kThreads) {
      const int j = i / pieces, c = i % pieces;
      const T* src = c < pl ? ckv_b + (size_t)(k0 + j) * L + c * CH
                            : kr_b + (size_t)(k0 + j) * R + (c - pl) * CH;
      cp_async16(dst + j * ldk + c * CH, src);
    }
  };
  if (ntiles > 0) issue(0, 0);
  cp_async_commit();

  // Q of the chunk's heads, f32, while the first tile is in flight
  for (int i = tid; i < kHeads * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    float x = 0.f;
    if (hh < nh) {
      const size_t row = (size_t)b * H + h0 + hh;
      x = d < L ? to_f32(q_abs[row * L + d]) : to_f32(q_rope[row * R + d - L]);
    }
    Qs[i] = x;
  }
  if (tid < kHeads) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  const int c0 = 2 * tid;  // this thread's output columns: c0, c0 + 1 (L is even)
  float acc[kHeads][2];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) acc[hh][0] = acc[hh][1] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {  // the other stage was released at the end of t - 1
      issue(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kc = Kt + (size_t)stage * kKeys * ldk;
    const int nvalid = min(kKeys, end - (start + t * kKeys));

    // partial scores: lane = key, this warp's pieces of the row
    float sp[kHeads];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) sp[hh] = 0.f;
    const T* krow = Kc + lane * ldk;
    for (int c = warp; c < pieces; c += kWarps) {
      float x[CH];
      load16(krow + c * CH, x);
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        const float* qp = Qs + hh * D + c * CH;
#pragma unroll
        for (int e = 0; e < CH; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + e);
          sp[hh] = fmaf(qv.x, x[e], sp[hh]);
          sp[hh] = fmaf(qv.y, x[e + 1], sp[hh]);
          sp[hh] = fmaf(qv.z, x[e + 2], sp[hh]);
          sp[hh] = fmaf(qv.w, x[e + 3], sp[hh]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) Sp[(warp * kHeads + hh) * kKeys + lane] = sp[hh];
    __syncthreads();

    // online softmax: a warp per head (heads warp, warp + 8), lane = key;
    // a lane past the tile's valid keys (its row never loaded) is masked
    for (int hh = warp; hh < kHeads; hh += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += Sp[(w * kHeads + hh) * kKeys + lane];
      s = lane < nvalid ? s * scale : -INFINITY;
      const float m_old = ms[hh];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float rs = warp_sum(p);
      Ps[lane * kHeads + hh] = operand(p, T());
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[hh] = corr;
        ls[hh] = ls[hh] * corr + rs;
        ms[hh] = m_new;
      }
    }
    __syncthreads();

    // acc += P V, V the tile's ckv columns
    if (c0 < L) {
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        acc[hh][0] *= cs[hh];
        acc[hh][1] *= cs[hh];
      }
      for (int j = 0; j < nvalid; ++j) {
        float v0, v1;
        load2(Kc + j * ldk + c0, v0, v1);
#pragma unroll
        for (int g = 0; g < kHeads; g += 4) {
          const float4 p = *reinterpret_cast<const float4*>(Ps + j * kHeads + g);
          acc[g][0] = fmaf(p.x, v0, acc[g][0]);
          acc[g][1] = fmaf(p.x, v1, acc[g][1]);
          acc[g + 1][0] = fmaf(p.y, v0, acc[g + 1][0]);
          acc[g + 1][1] = fmaf(p.y, v1, acc[g + 1][1]);
          acc[g + 2][0] = fmaf(p.z, v0, acc[g + 2][0]);
          acc[g + 2][1] = fmaf(p.z, v1, acc[g + 2][1]);
          acc[g + 3][0] = fmaf(p.w, v0, acc[g + 3][0]);
          acc[g + 3][1] = fmaf(p.w, v1, acc[g + 3][1]);
        }
      }
    }
    __syncthreads();  // the tile, P and the corrections are read
  }
  cp_async_wait<0>();  // nothing in flight when no tile was taken

  const size_t row0 = (size_t)b * H + h0;
  if (nsplit == 1) {
    if (c0 < L) {
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh)
        if (hh < nh) {
          const float inv = 1.f / fmaxf(ls[hh], 1e-30f);
          store(out + (row0 + hh) * L + c0, acc[hh][0] * inv);
          store(out + (row0 + hh) * L + c0 + 1, acc[hh][1] * inv);
        }
    }
    return;
  }

  // the partials, then the last block of this (row, head chunk) merges them
  // (threadFenceReduction's pattern: each block makes its writes visible
  // before it counts itself)
  if (tid < nh) {
    part_ml[((row0 + tid) * nsplit + split) * 2] = ms[tid];
    part_ml[((row0 + tid) * nsplit + split) * 2 + 1] = ls[tid];
  }
  if (c0 < L) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
      if (hh < nh) {
        float* dst = part_acc + ((row0 + hh) * nsplit + split) * L + c0;
        dst[0] = acc[hh][0];
        dst[1] = acc[hh][1];
      }
  }
  __shared__ int last;
  int* counter = counters + (size_t)b * gridDim.x + hc;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp per head: lanes over splits for the weights, then lanes over
  // columns with each split's row weighted in split order
  for (int hh = warp; hh < nh; hh += kWarps) {
    const size_t row = row0 + hh;
    const float* ml = part_ml + row * nsplit * 2;
    const float* pa = part_acc + row * nsplit * L;
    float mx = kNegInf;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    float lt = 0.f, at[kMaxL / 32];
#pragma unroll
    for (int e = 0; e < kMaxL / 32; ++e) at[e] = 0.f;
    for (int s0 = 0; s0 < nsplit; s0 += 32) {
      float w = 0.f, lw = 0.f;
      if (s0 + lane < nsplit) {
        w = expf(__ldcg(ml + 2 * (s0 + lane)) - mx);
        lw = __ldcg(ml + 2 * (s0 + lane) + 1) * w;
      }
      lt += warp_sum(lw);
      const int ns = min(32, nsplit - s0);
      for (int i = 0; i < ns; ++i) {
        const float wi = __shfl_sync(0xffffffffu, w, i);
        const float* src = pa + (size_t)(s0 + i) * L;
#pragma unroll
        for (int e = 0; e < kMaxL / 32; ++e)
          if (lane + 32 * e < L) at[e] = fmaf(wi, __ldcg(src + lane + 32 * e), at[e]);
      }
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int e = 0; e < kMaxL / 32; ++e)
      if (lane + 32 * e < L) store(out + row * L + lane + 32 * e, at[e] * inv);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <typename T>
cudaError_t launch(const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
                   const void* kv_len, void* out, float* ws, int* cnt, int B, int H, int S,
                   int L, int R, int nsplit, float scale, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(L + R);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static size_t attr = 48 * 1024;  // the largest dynamic shared memory allowed so far
  if (bytes > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr = bytes;
  }
  const int nchunks = (H + kHeads - 1) / kHeads;
  float* part_ml = ws;
  float* part_acc = ws == nullptr ? nullptr : ws + (size_t)B * H * nsplit * 2;
  const dim3 grid(nchunks, nsplit, B);
  mla_decode_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), static_cast<const int*>(kv_len), static_cast<T*>(out),
      part_ml, part_acc, cnt, H, S, L, R, nsplit, scale);
  return cudaGetLastError();
}

}  // namespace

// q_abs, out: (B, H, L); q_rope: (B, H, R); ckv: (B, S, L); krope: (B, S, R);
// kv_len: (B,) int32; all contiguous on the device, 16-byte aligned; L and R
// multiples of 8, L <= 512.  With nsplit > 1, ws is an f32 workspace of
// B * H * nsplit * (L + 2) floats and counters B * ceil(H / 16) int32 zeros,
// left zero again.  dtype 0 = float32, 1 = bfloat16.  One kernel launch;
// returns its cudaError_t (0 when it was accepted).
extern "C" int mla_decode(const void* q_abs, const void* q_rope, const void* ckv,
                          const void* krope, const void* kv_len, void* out, void* ws,
                          void* counters, int B, int H, int S, int L, int R, int nsplit,
                          float scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || L <= 0 || L > kMaxL || L % 8 != 0 ||
      R <= 0 || R % 8 != 0 || nsplit <= 0 || nsplit > 65535 ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_abs, q_rope, ckv, krope, kv_len, out, w, c, B, H, S, L, R, nsplit,
                         scale, st);
  if (dtype == 1)
    return launch<bf16>(q_abs, q_rope, ckv, krope, kv_len, out, w, c, B, H, S, L, R, nsplit,
                        scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* mla_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
