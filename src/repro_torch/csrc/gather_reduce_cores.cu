// Graph-core accumulator over the compressed edge stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_gather_reduce/kernel.py
// ::gather_reduce_cores_pallas (its pallas_call at kernel.py:354): laneless
// payload, min over uint32 or float32, sum over float32, and the optional
// saturating weight add of SSSP, on either schedule: the static per-(core,
// row block) tile counts, or the dynamic fetch map of the frontier-aware
// tile skip (a tile t runs iff fetch[c, r, t] == t). Both packed-word
// regimes are decoded:
//   16-bit: word = valid<<31 | dstb<<16 | src
//   32-bit: word = src, word_hi = valid<<31 | dstb
//
// What bounds it: bytes. Each slot of a tile that runs is read once (4 B of
// word, plus 4 B of word_hi and 4 B of weight where streamed) and needs one
// 4 B gather from the phase's payload block; there is one compare or add per
// slot, so the arithmetic is negligible beside the memory traffic.
//
// Design:
//   * One thread block per (core c, row block r): blockIdx = (r, c). A loop
//     inside the block replaces the TPU grid's sequential tile axis.
//   * The block first lists the tiles that run, kThreads candidate tiles at
//     a time: the static arm takes tiles t < counts[c, r], the dynamic arm
//     tests fetch[c, r, t] == t. A ballot and the per-warp counts compact
//     them into a shared list, then the block walks the listed tiles' slots,
//     kThreads slots per step, with coalesced word loads. Tiles that do not
//     run are never loaded, the GPU form of the TPU kernel's fetch elision.
//     The run test is a property of the tile, the same for every thread, so
//     every thread runs every step and the block barriers stay safe.
//   * The payload (G = p * sub_size values, up to 256 KiB in the 16-bit
//     regime) stays in device memory and is read through the read-only
//     cache; it is small enough to live in L2 for the whole launch. Only the
//     vb-row accumulator is in shared memory.
//   * min: shared-memory atomicMin. uint32 labels use it directly; float32
//     values are mapped to an order-preserving uint32 key first.
//   * sum: deterministic, so that PageRank gives the same bits on every run.
//     Within a warp, lanes that hit the same row are grouped with
//     __match_any_sync and the lowest such lane adds their values in lane
//     order. The per-warp partials are staged in shared memory and warp 0
//     adds them to the accumulator warp by warp. The order of every float
//     add is therefore fixed by the slot order alone.
//   * Rows no edge reaches keep the identity, which is what the level-2
//     split-row fold relies on for spare virtual rows.
// The wrapper (kernel.py) checks shapes, types and the shared-memory size
// before it calls the launcher; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMin = 0;
constexpr int kSum = 1;

__device__ __forceinline__ uint32_t f32_key(uint32_t bits) {
  // order-preserving map float -> uint32 (negative floats reversed)
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_f32(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

__global__ void __launch_bounds__(kThreads) gather_reduce_cores_kernel(
    const uint32_t* __restrict__ payload,  // (G,) uint32 or float32 bits
    const int32_t* __restrict__ word,      // (p, R, T, Eb)
    const int32_t* __restrict__ word_hi,   // (p, R, T, Eb) or null (16-bit)
    const float* __restrict__ weights,     // (p, R, T, Eb) or null
    const int32_t* __restrict__ counts,    // (p, R) real tiles per row block
    const int32_t* __restrict__ fetch,     // (p, R, T) fetch map or null
    uint32_t* __restrict__ out,            // (p, R * vb)
    int r_blocks, int t_tiles, int eb, int vb, int kind, int is_f32,
    int add, uint32_t identity) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                                 // vb rows
  float* st_val = reinterpret_cast<float*>(smem + vb);  // kThreads
  int* st_row = reinterpret_cast<int*>(st_val + kThreads);
  float* st_part = reinterpret_cast<float*>(st_row + kThreads);
  int* tiles = reinterpret_cast<int*>(st_part + kThreads);  // kThreads
  int* warp_n = tiles + kThreads;                           // kWarps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = (long long)blockIdx.y * r_blocks + blockIdx.x;
  const bool min_f32 = (kind == kMin) && is_f32;

  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  for (int j = tid; j < vb; j += kThreads) acc[j] = init;
  __syncthreads();

  const long long base = blk * (long long)t_tiles * eb;
  const float ident_f = __uint_as_float(identity);
  const int32_t* fetch_blk = fetch != nullptr ? fetch + blk * t_tiles : nullptr;
  // the static arm only needs to look at the first counts[c, r] tiles
  const int n_cand = fetch != nullptr ? t_tiles : counts[blk];

  for (int t0 = 0; t0 < n_cand; t0 += kThreads) {
    // list this chunk's tiles that run, in tile order
    const int tc = t0 + tid;
    const bool runs = tc < n_cand && (fetch_blk == nullptr || __ldg(fetch_blk + tc) == tc);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, runs);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n_run = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_n[w] : 0;
      n_run += warp_n[w];
    }
    if (runs) tiles[before + __popc(ballot & ((1u << lane) - 1u))] = tc;
    __syncthreads();

    // n_slots is the same for every thread, so every thread runs every step
    // and the block-wide barriers below are safe.
    const int n_slots = n_run * eb;
    for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
      const int s = s0 + tid;
      bool valid = false;
      int row = 0;
      uint32_t v = 0;
      if (s < n_slots) {
        const long long at = base + (long long)tiles[s / eb] * eb + s % eb;
        const int32_t w0 = __ldg(word + at);
        int src;
        if (word_hi != nullptr) {
          const int32_t hi = __ldg(word_hi + at);
          valid = hi < 0;
          row = hi & 0x7FFFFFFF;
          src = w0;
        } else {
          valid = w0 < 0;
          row = (w0 >> 16) & 0x7FFF;
          src = w0 & 0xFFFF;
        }
        if (valid) {
          v = __ldg(payload + src);
          if (add) {  // saturating min-plus map; no weights = unit weights
            const float x = __uint_as_float(v);
            const float step = weights != nullptr ? __ldg(weights + at) : 1.0f;
            v = __float_as_uint(x >= ident_f ? ident_f : x + step);
          }
        }
      }
      if (kind == kMin) {
        if (valid) atomicMin(acc + row, min_f32 ? f32_key(v) : v);
        continue;
      }
      // deterministic sum: lane-ordered within a warp, warp-ordered across
      st_val[tid] = valid ? __uint_as_float(v) : 0.0f;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, valid ? row : -1 - lane);
      __syncwarp();
      const bool leader = valid && lane == __ffs(peers) - 1;
      float part = 0.0f;
      if (leader) {
        for (unsigned m = peers; m != 0; m &= m - 1) {
          part += st_val[(warp << 5) + __ffs(m) - 1];
        }
      }
      st_row[tid] = leader ? row : -1;
      st_part[tid] = part;
      __syncthreads();
      if (warp == 0) {
        float* accf = reinterpret_cast<float*>(acc);
        for (int w = 0; w < kWarps; ++w) {
          // the leaders of one warp own distinct rows: no two lanes collide
          const int rr = st_row[(w << 5) + lane];
          if (rr >= 0) accf[rr] += st_part[(w << 5) + lane];
          __syncwarp();
        }
      }
      __syncthreads();
    }
    __syncthreads();  // the tile list and warp counts are rewritten next chunk
  }
  __syncthreads();

  uint32_t* dst = out + blk * vb;
  for (int j = tid; j < vb; j += kThreads) {
    dst[j] = min_f32 ? key_f32(acc[j]) : acc[j];
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for a row block of vb rows.
size_t gather_reduce_cores_smem_bytes(int vb) {
  return sizeof(uint32_t) * ((size_t)vb + 4 * kThreads + kWarps);
}

int gather_reduce_cores_launch(const void* payload, const void* word,
                               const void* word_hi, const void* weights,
                               const void* counts, const void* fetch,
                               void* out, int p,
                               int r_blocks, int t_tiles, int eb, int vb,
                               int kind, int is_f32, int add,
                               uint32_t identity, void* stream) {
  const size_t smem = gather_reduce_cores_smem_bytes(vb);
  cudaError_t err = cudaFuncSetAttribute(
      gather_reduce_cores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p == 0 || r_blocks == 0) return 0;
  gather_reduce_cores_kernel<<<dim3(r_blocks, p), kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int32_t*)word, (const int32_t*)word_hi,
      (const float*)weights, (const int32_t*)counts, (const int32_t*)fetch,
      (uint32_t*)out, r_blocks,
      t_tiles, eb, vb, kind, is_f32, add, identity);
  return (int)cudaGetLastError();
}

}  // extern "C"
