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
// and out = acc / max(l, 1e-30), rounded to the output type. As in the TPU
// kernel, m, l, acc and the scores are float32 whatever the input type.
//
// What bounds it: operations. A causal pass does 2 * 2 * B * Hq * D * S^2 / 2
// flops over (2 Hq + 2 Hkv) * S * D elements moved, hundreds of flops per
// byte. Two kernels, one per input type:
//
// float32 (flash_attention_kernel_f32): the TPU kernel's float32 arithmetic
// on the FMA units (67 TFLOP/s; a TF32 product would miss the float32
// tolerance).
//   * One block per (query block of bq rows, b * Hq + h): blockIdx.y = b *
//     Hq + h, blockIdx.x walks the query blocks from the last, so that the
//     causal blocks with the most KV blocks start first.
//   * kTpr threads per query row (1, 2 or 4 for D <= 32, 64, 128), each
//     holding 32 of the row's head dims of q and of the accumulator in
//     registers, as float4 chunks interleaved across the row's threads (the
//     threads of a row read adjacent 16 B of a K or V row: no bank
//     conflict; the rows of a warp read the same key: a broadcast).
//   * Per KV block: K and V are staged in shared memory (head dims past D
//     held at 0); pass 1 takes each of the row's scores (the row's threads
//     add their partial dot products with shuffles, so each holds the same
//     bits) into a bq x (bk + 1) score tile and the running max; pass 2
//     rescales acc and l once, then adds exp(s - m') * v key by key.
//   * Inside a block, a row stops at its own last key: a key above the
//     diagonal would add p = exp(-1e30 - m') = 0 and leave m unchanged, so
//     skipping it gives the same bits.
//
// bfloat16 (flash_attention_kernel_bf16): both products on the tensor cores
// with wgmma (Hopper's asynchronous warpgroup products, bf16 in, float32
// accumulation). At smollm-135m's layer at S = 32,768 the causal flops take
// 1.25 ms at the 989 TFLOP/s bf16 rate; with P in three parts (below) the
// products are 2x those flops, 2.5 ms.
//   * Numerics. The product of two bf16 values is exact in float32, so
//     S = Q.K^T is the TPU kernel's float32 score up to summation order. P
//     is float32 there too; rounding it to bf16 (as a library kernel does)
//     moves the output by more than one bf16 ulp. So P is split into bf16
//     parts, p = p_hi + p_mid + p_lo to within one float32 ulp, and the
//     three products with the same V tile go into one float32 accumulator.
//     Two parts (16 of p's bits, 1.5x the flops) are not enough: near-zero
//     outputs of short rows then miss the one-ulp gate (the CPU tests
//     emulate both). l sums the unrounded float32 p, as the TPU kernel
//     does. Each KV block's P.V is summed from zero and then added to acc
//     in float32 (acc = acc * alpha + pv).
//   * Tile. A warpgroup (128 threads) per 64 query rows, one or two a
//     block (bq and bk multiples of 16, at most 128; bq is rounded up to
//     64 and the rows past the query block are not written). Q sits in
//     shared memory for the whole KV sweep; head dims are padded to kDp (64
//     or 128) with zeros, which add nothing to either product.
//   * Shared memory: Q, K and V tiles in bf16, never widened, each in
//     blocks of 64 head dims with 128-byte rows whose 16-byte chunks are
//     XORed by the row (the 128-byte swizzle that the wgmma descriptors
//     name). S = Q.K^T reads Q and K through K-major descriptors; P.V takes
//     P from registers and V through an MN-major (transposed) descriptor.
//     TMA brings the tiles: one thread arms a stage's mbarrier with the
//     bytes to come and issues the copies (3-D tensor maps (D, S, B * H),
//     boxes of 64 head dims, the same swizzle, zeros past S and D); every
//     thread waits on the barrier's phase. A ring of kStages K/V tiles lets
//     the next KV block's copy run under this block's products. Rows whose
//     byte width is not a multiple of 16 (D % 8 != 0, or a base not 16-byte
//     aligned), which TMA cannot address, take plain stores into the tiles
//     (kVec = false).
//   * Online softmax on the accumulator fragments (each warp holds 16 rows
//     as mma.sync's C fragment): a row's max and sum come from the quad's
//     shuffles, p = 2^(s log2 e - m' log2 e) is one FMA and one ex2, and P
//     goes from the score fragments straight into the A registers of P.V
//     (split by bit operations, no conversions). No score tile goes to
//     shared memory. Each thread keeps its own part of l, added across the
//     quad once at the end.
//   * Causal: KV blocks wholly above the block's diagonal are neither loaded
//     nor computed; a warpgroup skips the products of a block wholly above
//     its own rows (the reference's p = 0, alpha = 1: the same bits); only
//     blocks that cross the diagonal or the end of S are masked.
//   * No atomics, and a fixed order of sums: the same bits every launch.
//
// Any S >= 1: the last query and KV blocks may be partial; rows past S
// write nothing, keys past S are never read. The wrapper (kernel.py) checks
// shapes, types, contiguity and tiles; the launcher returns a CUDA error
// code (cudaErrorInvalidValue for a shape it does not take: D > 128, more
// threads or shared memory than a block has, a bf16 tile that is not a
// multiple of 16 up to 128, or B * Hq past the grid's y extent).

#include <cuda.h>  // CUtensorMap; its encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

// ---- float32: FMA units -----------------------------------------------------

constexpr int kDpt = 32;             // head dims a thread holds
constexpr int kChunks = kDpt / 4;    // float4 chunks a thread holds
constexpr int kMaxThreads = 512;

template <int kTpr>
__global__ void __launch_bounds__(kMaxThreads) flash_attention_kernel_f32(
    const float* __restrict__ q,   // (B, Hq, S, D)
    const float* __restrict__ k,   // (B, Hkv, S, D)
    const float* __restrict__ v,   // (B, Hkv, S, D)
    float* __restrict__ out,       // (B, Hq, S, D)
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
      qr[4 * c + e] = (live && dd < d) ? q[q_base + (size_t)qpos * d + dd] : 0.0f;
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
      sk[r * kDp + c] = k[tile + i];
      sv[r * kDp + c] = v[tile + i];
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
  float* orow = out + q_base + (size_t)qpos * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * (c * kTpr + sub) + e;
      if (dd < d) orow[dd] = acc[4 * c + e] / denom;
    }
  }
}

template <int kTpr>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int b, int hq,
                       int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int kDp = kDpt * kTpr;
  const size_t smem = (size_t)(2 * bk * kDp + bq * (bk + 1)) * sizeof(float);
  const int threads = bq * kTpr;
  if (threads > kMaxThreads || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const long long n_q = (s_len + bq - 1) / bq;
  auto kern = flash_attention_kernel_f32<kTpr>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)n_q, (unsigned)(b * hq)), threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), hq, hq / hkv, s_len, d, bq, bk, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out, int b, int hq,
                         int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                         cudaStream_t st) {
  if (d <= 32) return launch_f32<1>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  if (d <= 64) return launch_f32<2>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  return launch_f32<4>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
}

// ---- bfloat16: tensor cores -------------------------------------------------

constexpr int kStages = 2;           // K/V tiles in flight
constexpr int kMaxTile = 128;        // bq, bk at most
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and TMA: thread 0 arms a stage's barrier with the bytes its
// copies will bring and issues them; every thread waits for the phase
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// box (c0, c1, c2) of a 3-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) -> three bf16 pairs (x0 in the low halves) whose sum is (x0, x1)
// to within one float32 ulp. Each part is the top 16 bits (sign, exponent,
// 7 mantissa bits) of what the parts before it left; the remainders are
// exact float32 differences. Bit operations, no conversions.
__device__ __forceinline__ void split3_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  constexpr uint32_t kTop = 0xffff0000u;
  uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  u0 = __float_as_uint(x0 - __uint_as_float(u0 & kTop));
  u1 = __float_as_uint(x1 - __uint_as_float(u1 & kTop));
  mid = __byte_perm(u0, u1, 0x7632);
  u0 = __float_as_uint(__uint_as_float(u0) - __uint_as_float(u0 & kTop));
  u1 = __float_as_uint(__uint_as_float(u1) - __uint_as_float(u1 & kTop));
  lo = __byte_perm(u0, u1, 0x7632);
}

// wgmma's ordering: fence before a warpgroup's products read registers the
// threads wrote, commit them as a group, wait for all but kPending groups
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// pin registers that asynchronous products read or write, so that the
// compiler moves no use of them across an issue or a wait
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// the threads' plain stores to shared memory, visible to the tensor cores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// offset (bf16 elements) of element (r, c) of a tile of `rows` rows, stored
// as blocks of rows x 64 columns with 128-byte rows whose 16-byte chunks are
// XORed by r % 8 (tile base 1024-byte aligned): the layout that TMA writes
// with its 128-byte swizzle and the wgmma descriptors read, written by hand
// on the plain-store path
__device__ __forceinline__ int sw128(int r, int c, int rows) {
  return (c >> 6) * (rows * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// d (64 x N float32 accumulator fragments) = A . B (+ d unless scale_d = 0),
// bf16 in. ss: A and B K-major in shared memory; rs_t: A from registers
// (each warp's 16 rows as the mma.sync A fragment), B MN-major.
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void ss(float (&d)[8], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7} "
        ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void ss(float (&d)[24], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23} "
        ", %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void ss(float (&d)[40], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39} "
        ", %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void ss(float (&d)[48], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47} "
        ", %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void ss(float (&d)[56], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55} "
        ", %56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63} "
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs_t(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63} "
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// a warpgroup per 64 query rows (bq rounded up to 64: rows past the query
// block are computed and not written); KV blocks of 16 kNk keys; head dims
// padded to kDp (64 or 128). kVec: rows of D are whole 16-byte chunks and
// TMA brings the tiles (tq, tk, tv: 3-D maps (D, S, B * H), boxes of 64 head
// dims, 128-byte swizzle, zeros past S and D); otherwise the threads store
// them with plain loads.
template <int kDp, int kNk, bool kVec>
__global__ void __launch_bounds__(2 * 128) flash_attention_kernel_bf16(
    const __nv_bfloat16* __restrict__ q,  // (B, Hq, S, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Hkv, S, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Hkv, S, D)
    __nv_bfloat16* __restrict__ out,      // (B, Hq, S, D)
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, int hq, int group, int s_len, int d, int bq,
    int causal, float scale) {
  constexpr int kBk = 16 * kNk;      // keys a KV block
  constexpr int kTile = kBk * kDp;   // K or V tile, elements
  constexpr int kQTile = 64 * kDp;   // a warpgroup's Q tile
  constexpr int kKt = kDp / 16;      // head-dim steps of 16
  constexpr int kNt = kBk / 8;       // score fragments of 8 keys
  constexpr int kBoxes = kDp / 64;   // 64-column blocks a tile
  constexpr uint32_t kKvBytes = 2 * kTile * sizeof(__nv_bfloat16);
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nthreads = blockDim.x;
  const int n_wg = nthreads / 128;
  __nv_bfloat16* sq = base;                    // n_wg x kQTile
  __nv_bfloat16* sk = sq + n_wg * kQTile;      // kStages x kTile
  __nv_bfloat16* sv = sk + kStages * kTile;    // kStages x kTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * kTile);  // kStages

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // within the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragment's row (and row + 8)
  const int t4 = lane & 3;  // the fragment's column pair
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hkv = hq / group;
  const int bh_kv = b * hkv + h / group;
  const int q0 = qi * bq;
  const int q_end = min(s_len, q0 + bq);      // rows this block writes
  const int w0 = q0 + 64 * wg;                // the warpgroup's first row
  const int w_last = min(w0 + 63, q_end - 1); // its last live row
  const bool wg_live = w0 < q_end;

  int n_kv = (s_len + kBk - 1) / kBk;
  if (causal) n_kv = min(n_kv, (q_end - 1) / kBk + 1);

  // K and V of block ki into stage ki % kStages; Q with block 0
  auto load_kv = [&](int ki) {
    const int st = ki % kStages;
    if constexpr (kVec) {
      if (tid != 0) return;
      const uint32_t bar = smem_addr(bars + st);
      mbar_expect_tx(bar, kKvBytes + (ki == 0 ? n_wg * kQTile * sizeof(__nv_bfloat16) : 0));
      for (int cb = 0; cb < kBoxes; ++cb) {
        if (ki == 0)
          for (int w = 0; w < n_wg; ++w)
            tma_load(smem_addr(sq + w * kQTile + cb * 64 * 64), &tq, bar, 64 * cb, q0 + 64 * w,
                     bh);
        tma_load(smem_addr(sk + st * kTile + cb * kBk * 64), &tk, bar, 64 * cb, ki * kBk, bh_kv);
        tma_load(smem_addr(sv + st * kTile + cb * kBk * 64), &tv, bar, 64 * cb, ki * kBk, bh_kv);
      }
    } else {  // plain stores; zeros past S and D (and past the query block for Q)
      const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
      auto rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int nr, int n) {
        for (int i = tid; i < n * kDp; i += nthreads) {
          const int r = i / kDp, c = i - r * kDp;
          dst[sw128(r, c, n)] = (r < nr && c < d) ? src[(size_t)(row0 + r) * d + c] : zero;
        }
      };
      if (ki == 0)
        for (int w = 0; w < n_wg; ++w)
          rows(sq + w * kQTile, q + (size_t)bh * s_len * d, q0 + 64 * w,
               max(0, q_end - q0 - 64 * w), 64);
      const size_t kv_base = (size_t)bh_kv * s_len * d;
      rows(sk + st * kTile, k + kv_base, ki * kBk, min(kBk, s_len - ki * kBk), kBk);
      rows(sv + st * kTile, v + kv_base, ki * kBk, min(kBk, s_len - ki * kBk), kBk);
    }
  };
  // every thread: block ki's stage (and Q) is in shared memory
  auto wait_kv = [&](int ki) {
    if constexpr (kVec) {
      mbar_wait(smem_addr(bars + ki % kStages), (ki / kStages) & 1);
    } else {
      fence_proxy_async();  // the plain stores, visible to the tensor cores
      __syncthreads();
    }
  };

  if (kVec && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(smem_addr(bars + st));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_kv(0);

  float acc[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_addr(sq + wg * kQTile);
  const int row_a = w0 + 16 * warp + g;  // this thread's rows: row_a, row_a + 8

  for (int ki = 0; ki < n_kv; ++ki) {
    if (ki + 1 < n_kv) load_kv(ki + 1);  // its copy runs under this block's products
    wait_kv(ki);
    const int k0 = ki * kBk;
    // a warpgroup skips a block wholly above its rows' diagonal (the
    // reference's p = 0, alpha = 1: the same bits)
    if (wg_live && !(causal && k0 > w_last)) {
      const uint32_t k_addr = smem_addr(sk + (ki % kStages) * kTile);
      const uint32_t v_addr = smem_addr(sv + (ki % kStages) * kTile);
      // S = Q . K^T, 64 rows x kBk keys: Q and K K-major (rows of 128 bytes,
      // 8-row groups 1024 bytes apart); a step of 16 head dims moves 32
      // bytes along the swizzled row, the fifth the next 64-column block
      float s[4 * kNt];
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da = sw128_desc(q_addr + (kk >> 2) * (64 * 128) + off, 16, 1024);
        const uint64_t db = sw128_desc(k_addr + (kk >> 2) * (kBk * 128) + off, 16, 1024);
        Wgmma<kBk>::ss(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      // scale; mask only a block that crosses the diagonal or S
      const bool edge = (causal && k0 + kBk - 1 > w0) || k0 + kBk > s_len;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int row = row_a + 8 * (e >> 1);
            if ((causal && key > row) || key >= s_len) x = kNeg;
          }
          s[4 * j + e] = x;
        }
      }
      // online softmax on the fragments: a row lives in one quad. p =
      // 2^(s log2 e - m' log2 e) as one FMA, whose rounding of m' log2 e is
      // the same for the whole row and cancels in acc / l
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float alpha[2], mxl[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx((m_r[r] - mx[r]) * kLog2e);
        m_r[r] = mx[r];
        mxl[r] = mx[r] * kLog2e;
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[4 * j + e], kLog2e, -mxl[e >> 1]));
          s[4 * j + e] = p;
          ps[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];

      // pv = p_lo . V + p_mid . V + p_hi . V from zero, 16 keys at a time:
      // the score fragments of keys 16 kc .. 16 kc + 15 are the register A
      // operand; V is MN-major (head dims contiguous: 8-key groups 1024
      // bytes apart, 64-column blocks kBk x 128 bytes apart). The products
      // read A asynchronously, so its registers alternate between two sets.
      // Then acc = acc * alpha + pv: a sum kept in the tensor cores'
      // accumulator across all KV blocks drifted by ~1e-6 at S = 32,768.
      float pv[kDp / 2];
      uint32_t pa[2][3][4];
#pragma unroll
      for (int kc = 0; kc < kNk; ++kc) {
        uint32_t (&cur)[3][4] = pa[kc & 1];
        if (kc >= 2) wg_wait<1>();  // the products that read this buffer are done
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kc + (e >> 1), c = 2 * (e & 1);
          split3_bf16x2(s[4 * j + c], s[4 * j + c + 1], cur[0][e], cur[1][e], cur[2][e]);
        }
#pragma unroll
        for (int part = 0; part < 3; ++part) fence_regs(cur[part]);
        if (kc == 0) fence_regs(pv);
        wg_fence();
        const uint64_t db = sw128_desc(v_addr + kc * 16 * 128, kBk * 128, 1024);
#pragma unroll
        for (int part = 2; part >= 0; --part)
          Wgmma<kDp>::rs_t(pv, cur[part], db, kc > 0 || part < 2);
        wg_commit();
      }
      wg_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    }
    __syncthreads();  // the stage is free for the block after next
  }

  if (!wg_live) return;
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l_r[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    den[r] = fmaxf(lt, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j) {
    const int c = 8 * j + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= q_end || c >= d) continue;
      const float x0 = acc[4 * j + 2 * r] / den[r];
      const float x1 = acc[4 * j + 2 * r + 1] / den[r];
      __nv_bfloat16* orow = out + ((size_t)bh * s_len + row) * d;
      if constexpr (kVec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        orow[c] = __float2bfloat16(x0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found at first use (no driver library
// is linked)
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a TMA map of a (B * H, S, D) bf16 tensor: boxes of `rows` x 64 head dims,
// 128-byte swizzle, zeros past S and D
bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int s_len, int d, int rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s_len, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s_len * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDp, int kNk, bool kVec>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int hq,
                        int hkv, int s_len, int d, int bq, int causal, float scale,
                        cudaStream_t stream) {
  const int n_wg = (bq + 63) / 64;
  const size_t smem = 1024 +
                      (size_t)(n_wg * 64 * kDp + 2 * kStages * 16 * kNk * kDp) *
                          sizeof(__nv_bfloat16) +
                      kStages * sizeof(uint64_t);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap tq{}, tk{}, tv{};
  if (kVec && !(tensor_map(&tq, q, b * hq, s_len, d, 64) &&
                tensor_map(&tk, k, b * hkv, s_len, d, 16 * kNk) &&
                tensor_map(&tv, v, b * hkv, s_len, d, 16 * kNk)))
    return cudaErrorInvalidValue;
  const long long n_q = (s_len + bq - 1) / bq;
  auto kern = flash_attention_kernel_bf16<kDp, kNk, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)n_q, (unsigned)(b * hq)), 128 * n_wg, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), tq, tk, tv, hq,
      hq / hkv, s_len, d, bq, causal, scale);
  return cudaGetLastError();
}

template <int kDp, bool kVec>
cudaError_t dispatch_bk(const void* q, const void* k, const void* v, void* out, int b, int hq,
                        int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                        cudaStream_t st) {
#define FLASH_BK(n)                                                                         \
  case n:                                                                                   \
    return launch_bf16<kDp, n, kVec>(q, k, v, out, b, hq, hkv, s_len, d, bq, causal, scale, \
                                     st);
  switch (bk / 16) {
    FLASH_BK(1) FLASH_BK(2) FLASH_BK(3) FLASH_BK(4) FLASH_BK(5) FLASH_BK(6) FLASH_BK(7)
    FLASH_BK(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BK
}

template <bool kVec>
cudaError_t dispatch_dp(const void* q, const void* k, const void* v, void* out, int b, int hq,
                        int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                        cudaStream_t st) {
  if (d <= 64)
    return dispatch_bk<64, kVec>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  return dispatch_bk<128, kVec>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* out, int b, int hq,
                          int hkv, int s_len, int d, int bq, int bk, int causal, float scale,
                          cudaStream_t st) {
  if (bq % 16 || bk % 16 || bq > kMaxTile || bk > kMaxTile) return cudaErrorInvalidValue;
  // TMA: 16-byte aligned rows and bases
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (vec)
    return dispatch_dp<true>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  return dispatch_dp<false>(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int b, int hq, int hkv, int s_len, int d,
                                      int bq, int bk, int causal, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s_len < 1 || d < 1 || d > 4 * kDpt ||
      bq < 1 || bk < 1 || (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_f32(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  else if (dtype == 1)
    err = dispatch_bf16(q, k, v, out, b, hq, hkv, s_len, d, bq, bk, causal, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
