// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// key tiles, causal or not, with a query offset and grouped KV heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention).  Same function: query i of
// a block sits at position q_offset + i, keys k < Sk are valid, a causal
// query sees keys k <= its position, query head h reads KV head h / group,
// and (m, l, acc) accumulate in f32 with m starting at -1e30 and the output
// acc / max(l, 1e-30), so a row with no visible key gives 0.
//
// What bounds it on this card: operations, on the main path.  A causal pass
// over S keys does about 2 * B * Hq * S^2 * hd FLOPs on 4 * B * Hq * S * hd
// elements read or written, S / 8 FLOPs per byte in f32: above the card's
// ~20 (67 TFLOP/s over 3.35 TB/s) from S = 160 on, so the main path's f32
// prefill (S = 256) is bound by the FLOP rate.  In bf16 the ratio is S / 4
// against the tensor cores' ~295, so bytes bound it below S of about 1,200.
//
// What the design does about it, in this first version: it keeps every
// intermediate on the chip (the (Sq, Sk) score matrix never reaches device
// memory) and skips work that cannot count: a causal block stops at its last
// visible key.  One block owns one (b * Hq + h, 32-query tile); 128 threads,
// four to a query row.  A 64-key tile of K and V is staged in shared memory
// as f32; each thread computes 16 scores of its row, the row's four threads
// reduce max and sum with shuffles, and each thread keeps hd / 4 output
// columns in registers.  The products run on the CUDA cores in f32, bf16
// inputs included: the tensor cores (wgmma, 989 TFLOP/s in bf16) and TMA
// loads are what a later version adds to approach the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 32;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128; // 4 threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (HD + 1) + (size_t)kBQ * (kBK + 1));
}

// HD: upper bound on hd (rows are zero-padded to it in shared memory).
// q, out: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd); all contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Sq, int Sk, int hd, int causal, int q_offset, float scale) {
  constexpr int ld = HD + 1;
  constexpr int ldp = kBK + 1;
  constexpr int SPT = kBK / 4;  // scores per thread per tile
  constexpr int CPT = HD / 4;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;    // [kBK][ld]
  float* Vs = Ks + kBK * ld;    // [kBK][ld]
  float* Ps = Vs + kBK * ld;    // [kBQ][ldp]

  const int bh = blockIdx.y;    // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, r = tid / 4, c4 = tid % 4;
  const T* qb = q + (size_t)bh * Sq * hd;
  const T* kb = k + (size_t)(b * Hkv + kvh) * Sk * hd;
  const T* vb = v + (size_t)(b * Hkv + kvh) * Sk * hd;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + rr < Sq && d < hd) x = to_f32(qb[(size_t)(q0 + rr) * hd + d]) * scale;
    Qs[rr * ld + d] = x;
  }

  // keys past k_end are invisible to every query of this block
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kBQ, Sq));
  const int qpos = q_offset + q0 + r;

  float m_i = kNegInf, l_i = 0.f;
  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int jj = i / HD, d = i % HD, kj = k0 + jj;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk && d < hd) {
        kx = to_f32(kb[(size_t)kj * hd + d]);
        vx = to_f32(vb[(size_t)kj * hd + d]);
      }
      Ks[jj * ld + d] = kx;
      Vs[jj * ld + d] = vx;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * ld + d];
#pragma unroll
      for (int i = 0; i < SPT; ++i) s[i] += qd * Ks[(c4 + 4 * i) * ld + d];
    }

    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int kj = k0 + c4 + 4 * i;
      const bool ok = kj < Sk && (!causal || qpos >= kj);
      s[i] = ok ? s[i] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int kj = k0 + c4 + 4 * i;
      const bool ok = kj < Sk && (!causal || qpos >= kj);
      const float p = ok ? expf(s[i] - m_new) : 0.f;
      Ps[r * ldp + c4 + 4 * i] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * corr + rs;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] *= corr;
    __syncwarp();  // a row's probabilities come from the row's own 4 lanes

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * ldp + j];
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[e] += p * Vs[j * ld + c4 + 4 * e];
    }
  }

  if (q0 + r < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* ob = out + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int d = c4 + 4 * e;
      if (d < hd) store(ob + d, acc[e] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                      int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq), block(kThreads);
  flash_kernel<T, HD><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, hd,
      causal, q_offset, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                         int hd, int causal, int q_offset, cudaStream_t st) {
  if (hd <= 64) return launch_hd<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  if (hd <= 128) return launch_hd<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd); all contiguous on the
// device.  dtype 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 when it was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Sk, int hd, int causal, int q_offset,
                               int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || Hq % Hkv != 0 ||
      B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
