// Causal (or non-causal) grouped-query flash attention, forward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// ::flash_attention_pallas (its pallas_call at kernel.py:103, body _kernel at
// kernel.py:30). q (B, Hq, S, D), k and v (B, Hkv, S, D), float32 or
// bfloat16, contiguous; out (B, Hq, S, D) in q's type. Query head h reads kv
// head h / (Hq / Hkv): K and V are never repeated. Per query row, over the
// KV blocks of bk keys in order, with m = -1e30, l = 0, acc = 0 to start:
//   s = (q . k) * scale                    (float32; -1e30 where kpos > qpos)
//   m' = max(m, max s); alpha = exp(m - m'); p = exp(s - m')
//   l = l * alpha + sum p; acc = acc * alpha + p . v; m = m'
// and out = acc / max(l, 1e-30), rounded to the output type. Inputs are
// widened to float32 as the TPU kernel does; every operation is a float32
// FMA or add, and m, l, acc stay float32.
//
// What bounds it: operations. A causal pass does 2 * 2 * B * Hq * D * S^2 / 2
// flops over (2 Hq + 2 Hkv) * S * D elements moved, hundreds of flops per
// byte. The tensor cores would make it run near the byte line; this first
// kernel keeps the TPU kernel's float32 arithmetic on the FMA units (67
// TFLOP/s), so it is slower than a tensor-core kernel by design (PERF.md).
//
// Design:
//   * One block per (query block of bq rows, b * Hq + h): blockIdx.y = b *
//     Hq + h, blockIdx.x walks the query blocks from the last, so that the
//     causal blocks with the most KV blocks start first.
//   * kTpr threads per query row (1, 2 or 4 for D <= 32, 64, 128), each
//     holding 32 of the row's head dims of q and of the accumulator in
//     registers, as float4 chunks interleaved across the row's threads (the
//     threads of a row read adjacent 16 B of a K or V row: no bank
//     conflict; the rows of a warp read the same key: a broadcast).
//   * Per KV block: K and V are staged in shared memory as float32 (head
//     dims past D held at 0); pass 1 takes each of the row's scores (the
//     row's threads add their partial dot products with shuffles, so each
//     holds the same bits) into a bq x (bk + 1) score tile and the running
//     max; pass 2 rescales acc and l once, then adds exp(s - m') * v key by
//     key. The block then moves on; nothing reaches device memory but out.
//   * KV blocks wholly above the diagonal (ki * bk > qi * bq + bq - 1) are
//     neither loaded nor computed. Inside a block, a row stops at its own
//     last key: a key above the diagonal would add p = exp(-1e30 - m') = 0
//     and leave m unchanged, so skipping it gives the same bits.
//   * Any S >= 1: the last query and KV blocks may be partial; rows past S
//     compute nothing and write nothing, keys past S are never read.
// The wrapper (kernel.py) checks shapes, types and contiguity; the launcher
// returns a CUDA error code (cudaErrorInvalidValue for a shape it does not
// take: D > 128, more than 512 threads a block, more shared memory than a
// block has, or B * Hq past the grid's y extent).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kDpt = 32;             // head dims a thread holds
constexpr int kChunks = kDpt / 4;    // float4 chunks a thread holds
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

template <typename T, int kTpr>
__global__ void __launch_bounds__(kMaxThreads) flash_attention_kernel(
    const T* __restrict__ q,   // (B, Hq, S, D)
    const T* __restrict__ k,   // (B, Hkv, S, D)
    const T* __restrict__ v,   // (B, Hkv, S, D)
    T* __restrict__ out,       // (B, Hq, S, D)
    int hq, int group, int s_len, int d, int bq, int bk, int causal, float scale) {
  constexpr int kDp = kDpt * kTpr;  // row width in shared memory
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // bk x kDp
  float* sv = sk + bk * kDp;                    // bk x kDp
  float* ss = sv + bk * kDp;                    // bq x (bk + 1): the block's scores
  const int ss_ld = bk + 1;

  const int tid = threadIdx.x;
  const int row = tid / kTpr;
  const int sub = tid % kTpr;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hkv = hq / group;
  const size_t q_base = (size_t)bh * s_len * d;
  const size_t kv_base = ((size_t)b * hkv + h / group) * s_len * d;
  const int q0 = qi * bq;
  const int qpos = q0 + row;
  const bool live = qpos < s_len;
  // the row's threads are kTpr adjacent lanes of one warp
  const unsigned lane = tid & 31;
  const unsigned gmask = (kTpr == 1) ? (1u << lane)
                                     : (((1u << kTpr) - 1u) << (lane & ~(unsigned)(kTpr - 1)));

  for (int i = tid; i < 2 * bk * kDp; i += blockDim.x) sk[i] = 0.0f;  // K and V, pads too

  float qr[kDpt], acc[kDpt];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (c * kTpr + sub) + e;
      qr[4 * c + e] = (live && dd < d) ? widen(q[q_base + (size_t)qpos * d + dd]) : 0.0f;
      acc[4 * c + e] = 0.0f;
    }
  }
  float m = kNeg, l = 0.0f;

  int n_kv = (s_len + bk - 1) / bk;
  if (causal) n_kv = min(n_kv, (q0 + bq - 1) / bk + 1);
  for (int ki = 0; ki < n_kv; ++ki) {
    const int k0 = ki * bk;
    const int kn = min(bk, s_len - k0);
    __syncthreads();  // the previous block's readers are done
    const size_t tile = kv_base + (size_t)k0 * d;
    for (int i = tid; i < kn * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      sk[r * kDp + c] = widen(k[tile + i]);
      sv[r * kDp + c] = widen(v[tile + i]);
    }
    __syncthreads();
    int jn = causal ? min(kn, qpos - k0 + 1) : kn;  // the keys this row sees
    if (!live) jn = 0;
    if (jn <= 0) continue;  // the reference's p = 0, alpha = 1: the row is unchanged

    // pass 1: scores and their max
    float m_new = m;
    for (int j = 0; j < jn; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sk + j * kDp);
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = kr[c * kTpr + sub];
        part = fmaf(qr[4 * c + 0], kk.x, part);
        part = fmaf(qr[4 * c + 1], kk.y, part);
        part = fmaf(qr[4 * c + 2], kk.z, part);
        part = fmaf(qr[4 * c + 3], kk.w, part);
      }
#pragma unroll
      for (int off = kTpr / 2; off > 0; off >>= 1) part += __shfl_xor_sync(gmask, part, off);
      const float sc = part * scale;
      if (sub == 0) ss[row * ss_ld + j] = sc;
      m_new = fmaxf(m_new, sc);
    }
    __syncwarp(gmask);

    // pass 2: rescale once, then add each key's p * v
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
    float psum = 0.0f;
    for (int j = 0; j < jn; ++j) {
      const float p = expf(ss[row * ss_ld + j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(sv + j * kDp);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vr[c * kTpr + sub];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncwarp(gmask);
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = out + q_base + (size_t)qpos * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (c * kTpr + sub) + e;
      if (dd < d) narrow(acc[4 * c + e] / denom, orow + dd);
    }
  }
}

template <typename T, int kTpr>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int kDp = kDpt * kTpr;
  const size_t smem = (size_t)(2 * bk * kDp + bq * (bk + 1)) * sizeof(float);
  const int threads = bq * kTpr;
  if (threads > kMaxThreads || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const long long bh = (long long)b * hq;
  const long long n_q = (s_len + bq - 1) / bq;
  if (bh > 65535 || n_q > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<T, kTpr>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)n_q, (unsigned)bh), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hq / hkv, s_len, d, bq, bk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                     int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                     cudaStream_t stream) {
  if (d <= 32) return launch<T, 1>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, stream);
  if (d <= 64) return launch<T, 2>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, stream);
  return launch<T, 4>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int b, int hq, int hkv, int s_len, int d,
                                      int bq, int bk, int causal, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s_len < 1 || d < 1 || d > 4 * kDpt ||
      bq < 1 || bk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
