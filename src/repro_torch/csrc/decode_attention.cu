// Flash-decode for Hopper (sm_90a): one query token per (batch row, KV head)
// against a KV cache, each batch row at its own length.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention).  It computes the same
// function with one change of interface: kv_len is a (B,) int32 vector on the
// device, so slots at different depths share one launch (the TPU kernel takes
// one scalar length for the whole batch).  The kernel reads kv_len itself; the
// host never waits to learn it.
//
// What bounds it on this card: bytes.  A (b, kv head) pair reads each of its
// kv_len[b] valid K and V rows once (2 * kv_len * hd elements) and does
// 4 * group * hd FLOPs per row pair: group / 2 FLOPs per byte in f32 (0.5 on
// the main path), where the card needs about 20 (67 TFLOP/s over 3.35 TB/s)
// before compute binds.
//
// What the design does about it:
//  * the loop stops at kv_len[b]; the rows past it are never read (the TPU
//    kernel streams all S rows and masks them);
//  * the group's queries stay in registers, pre-scaled, while K/V stream by;
//  * each warp reads whole K and V rows with its 32 lanes on neighbouring
//    addresses, and keeps kUnroll rows in flight at once;
//  * each warp keeps its own online-softmax state (m, l, acc) in f32
//    registers; the block merges its warps' states in shared memory at the
//    end.  The conventions are the TPU kernel's: m starts at -1e30 and the
//    output is acc / max(l, 1e-30), so a row with no valid key gives 0.
// Known limit: one block per (b, kv head) is B * Hkv blocks, 64 to 128 on the
// main path, fewer than the card's 132 SMs.  Splitting the KV axis over
// several blocks and merging their states is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// EPL: elements of a row each lane owns (d = lane + 32 * e); G: query heads
// per KV head.  q, out: (B, Hkv * G, hd); k, v: (B, Hkv, S, hd); all contiguous.
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, int Hkv, int S, int hd, float scale) {
  const int b = blockIdx.x / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = min(max(kv_len[b], 0), S);
  const size_t head = blockIdx.x;  // b * Hkv + kv head
  const T* kb = k + head * S * hd;
  const T* vb = v + head * S * hd;
  const T* qb = q + head * G * hd;

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = d < hd ? to_f32(qb[g * hd + d]) * scale : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int j0 = warp * kUnroll; j0 < n; j0 += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        const bool ok = j < n && d < hd;
        kr[u][e] = ok ? to_f32(kb[(size_t)j * hd + d]) : 0.f;
        vr[u][e] = ok ? to_f32(vb[(size_t)j * hd + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= n) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[g][e] * kr[u][e];
        s = warp_sum(s);
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  __shared__ float s_acc[kWarps][G][32 * EPL];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane + 32 * e] = acc[g][e];
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float tot_l = 0.f, tot_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);
      tot_l += s_l[w][g] * c;
      tot_a += s_acc[w][g][d] * c;
    }
    store(out + head * G * hd + idx, tot_a / fmaxf(tot_l, 1e-30f));
  }
}

template <typename T, int EPL>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, int B, int Hkv, int S,
                         int hd, int G, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)hd);
  const dim3 grid(B * Hkv), block(kThreads);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const int* len = static_cast<const int*>(kv_len);
  T* o = static_cast<T*>(out);
  switch (G) {
    case 1: decode_kernel<T, EPL, 1><<<grid, block, 0, stream>>>(qq, kk, vv, len, o, Hkv, S, hd, scale); break;
    case 2: decode_kernel<T, EPL, 2><<<grid, block, 0, stream>>>(qq, kk, vv, len, o, Hkv, S, hd, scale); break;
    case 4: decode_kernel<T, EPL, 4><<<grid, block, 0, stream>>>(qq, kk, vv, len, o, Hkv, S, hd, scale); break;
    case 8: decode_kernel<T, EPL, 8><<<grid, block, 0, stream>>>(qq, kk, vv, len, o, Hkv, S, hd, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, int B, int Hkv, int S,
                         int hd, int G, cudaStream_t stream) {
  if (hd <= 32) return launch_group<T, 1>(q, k, v, kv_len, out, B, Hkv, S, hd, G, stream);
  if (hd <= 64) return launch_group<T, 2>(q, k, v, kv_len, out, B, Hkv, S, hd, G, stream);
  if (hd <= 128) return launch_group<T, 4>(q, k, v, kv_len, out, B, Hkv, S, hd, G, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, Hq, hd); k, v: (B, Hkv, S, hd); kv_len: (B,) int32; all
// contiguous on the device.  dtype 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t (0 when it was accepted).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, int B, int Hq,
                                int Hkv, int S, int hd, int dtype,
                                void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || hd <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(q, k, v, kv_len, out, B, Hkv, S, hd, G, st);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(q, k, v, kv_len, out, B, Hkv, S, hd, G, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
