// Push (scatter) accumulator over the source-binned edge stream, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_gather_reduce/kernel.py
// ::scatter_reduce_cores_pallas (its pallas_call at kernel.py:484): min over
// uint32 (BFS/WCC) or float32 with the optional saturating weight add
// (SSSP), and, on a payload with a trailing lane axis (multi-query batches),
// vector min and the word OR of packed multi-source BFS, on the static tile
// counts or the dynamic fetch map (a tile t of source block b runs iff
// fetch[c, b, t] == t). Both packed-word regimes are decoded, with dst the
// FULL local row:
//   16-bit: word = valid<<31 | dst<<16 | src
//   32-bit: word = src, word_hi = valid<<31 | dst
//
// What bounds it: bytes. Each slot of a tile that runs is read once (4 B of
// word, plus 4 B of word_hi and 4 B of weight where streamed), with one 4 B
// payload gather and one atomic into the output per query lane; one compare
// per slot and lane.
//
// Design:
//   * The accumulator is the whole per-core label row. The TPU keeps it in
//     VMEM across the (B, Tp) sweep; here one core's row is up to 1 MiB
//     (Vl = 262,144), more than a block's shared memory, so the output in
//     device memory is the accumulator. The launcher fills it with the
//     identity, the scatter kernel does global atomicMin, and for float32 a
//     third kernel maps the order-preserving keys back to floats. Min is
//     order-free, so the result does not depend on the order of the atomics.
//   * Parallel over tiles, not over (core, block): with one source block per
//     core a (p, B) grid would be 4 blocks for 132 SMs. Each warp takes one
//     tile at a time, in a grid-stride loop over all p * B * Tp tiles, and
//     leaves it at once when the tile does not run (a warp-uniform test), so
//     tiles that do not run cost one 4 B read of the counts or fetch map.
//     A tile's Eb slots are read by the warp's 32 threads, coalesced.
//   * Before its atomic a thread reads the row (through L2) and skips the
//     atomic when its value is not smaller. The row only decreases while the
//     kernel runs, so a stale read can only be larger than the row and
//     never skips an atomic that would have lowered it; on hub rows most
//     atomics are skipped.
//   * Query lanes: the payload is (G, L) and the output (p, num_rows, L); a
//     laneless (G,) payload is the case L = 1, which has the same layout. A
//     thread decodes its slot's word (and reads its weight) once, then
//     updates the L cells of the row, with atomicMin on uint32 or order-keyed
//     float32, or atomicOr on packed reach words (multi-source BFS). The OR
//     skip test is the same argument as min's: the row only gains bits, so a
//     stale read that already holds every bit of the value proves the atomic
//     would change nothing.
// The wrapper (scatter.py) checks shapes and types before it calls the
// launcher; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks of 256 on each SM

__host__ __device__ __forceinline__ uint32_t f32_key(uint32_t bits) {
  // order-preserving map float -> uint32 (negative floats reversed)
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_f32(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

__global__ void scatter_reduce_cores_fill_kernel(uint32_t* __restrict__ out,
                                                 long long n, uint32_t value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = value;
  }
}

__global__ void scatter_reduce_cores_unkey_kernel(uint32_t* __restrict__ out,
                                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = key_f32(out[i]);
  }
}

__global__ void __launch_bounds__(kThreads) scatter_reduce_cores_kernel(
    const uint32_t* __restrict__ payload,  // (G, L) uint32 or float32 bits
    const int32_t* __restrict__ word,      // (p, B, Tp, Eb)
    const int32_t* __restrict__ word_hi,   // (p, B, Tp, Eb) or null (16-bit)
    const float* __restrict__ weights,     // (p, B, Tp, Eb) or null
    const int32_t* __restrict__ counts,    // (p, B) real tiles per source block
    const int32_t* __restrict__ fetch,     // (p, B, Tp) fetch map or null
    uint32_t* __restrict__ out,            // (p, num_rows, L), keys for float32
    long long n_tiles, int t_tiles, int b_blocks, int eb, int num_rows,
    int lanes, int is_or, int is_f32, int add, uint32_t identity) {
  const int lane = threadIdx.x & 31;
  const long long first = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  const float ident_f = __uint_as_float(identity);

  for (long long tile = first; tile < n_tiles; tile += stride) {
    const long long cb = tile / t_tiles;  // c * B + b
    const int t = (int)(tile - cb * t_tiles);
    const bool runs =
        fetch != nullptr ? __ldg(fetch + tile) == t : t < __ldg(counts + cb);
    if (!runs) continue;  // the same for every lane of the warp
    uint32_t* out_c = out + (cb / b_blocks) * (long long)num_rows * lanes;
    const long long base = tile * eb;
    for (int e = lane; e < eb; e += 32) {
      const int32_t w0 = __ldg(word + base + e);
      bool valid;
      int dst, src;
      if (word_hi != nullptr) {
        const int32_t hi = __ldg(word_hi + base + e);
        valid = hi < 0;
        dst = hi & 0x7FFFFFFF;
        src = w0;
      } else {
        valid = w0 < 0;
        dst = (w0 >> 16) & 0x7FFF;
        src = w0 & 0xFFFF;
      }
      if (!valid) continue;
      const uint32_t* prow = payload + (long long)src * lanes;
      uint32_t* cell = out_c + (long long)dst * lanes;
      const float step = (add && weights != nullptr) ? __ldg(weights + base + e) : 1.0f;
      for (int l = 0; l < lanes; ++l) {
        uint32_t v = __ldg(prow + l);
        if (is_or) {
          if ((v & ~__ldcg(cell + l)) != 0u) atomicOr(cell + l, v);
          continue;
        }
        if (add) {  // saturating min-plus map; the slot's weight on every lane
          const float x = __uint_as_float(v);
          v = __float_as_uint(x >= ident_f ? ident_f : x + step);
        }
        if (is_f32) v = f32_key(v);
        if (v < __ldcg(cell + l)) atomicMin(cell + l, v);
      }
    }
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

int scatter_reduce_cores_launch(const void* payload, const void* word,
                                const void* word_hi, const void* weights,
                                const void* counts, const void* fetch,
                                void* out, int p, int b_blocks, int t_tiles,
                                int eb, int num_rows, int lanes, int is_or,
                                int is_f32, int add, uint32_t identity,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_out = (long long)p * num_rows * lanes;
  if (n_out == 0) return 0;
  uint32_t* acc = (uint32_t*)out;
  const bool keyed = is_f32 && !is_or;
  scatter_reduce_cores_fill_kernel<<<grid_for(n_out), kThreads, 0, s>>>(
      acc, n_out, keyed ? f32_key(identity) : identity);
  const long long n_tiles = (long long)p * b_blocks * t_tiles;
  if (n_tiles > 0) {
    // one warp per tile
    scatter_reduce_cores_kernel<<<grid_for(n_tiles * 32), kThreads, 0, s>>>(
        (const uint32_t*)payload, (const int32_t*)word, (const int32_t*)word_hi,
        (const float*)weights, (const int32_t*)counts, (const int32_t*)fetch,
        acc, n_tiles, t_tiles, b_blocks, eb, num_rows, lanes, is_or, is_f32,
        add, identity);
  }
  if (keyed) {
    scatter_reduce_cores_unkey_kernel<<<grid_for(n_out), kThreads, 0, s>>>(
        acc, n_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
