// Graph-core accumulator over the compressed edge stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_gather_reduce/kernel.py
// ::gather_reduce_cores_pallas (its pallas_call at kernel.py:354): min over
// uint32 or float32, sum over float32, the optional saturating weight add of
// SSSP, and, on a payload with a trailing lane axis (multi-query batches),
// the word OR of packed multi-source BFS, on either schedule: the static
// per-(core, row block) tile counts, or the dynamic fetch map of the
// frontier-aware tile skip (a tile t runs iff fetch[c, r, t] == t). Both
// packed-word regimes are decoded:
//   16-bit: word = valid<<31 | dstb<<16 | src
//   32-bit: word = src, word_hi = valid<<31 | dstb
//
// What bounds it: bytes. Each slot of a tile that runs is read once (4 B of
// word, plus 4 B of word_hi and 4 B of weight where streamed) and needs one
// 4 B gather from the phase's payload block per query lane; there is one
// compare or add per slot and lane, so the arithmetic is negligible beside
// the memory traffic.
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
//   * Two kernels share the tile listing and the slot decode (device
//     helpers below) and one launcher: gather_reduce_cores_kernel for one
//     lane (a laneless (G,) payload, or one packed reach word), and
//     gather_reduce_cores_lanes_kernel for a (G, L) payload with L >= 2.
//     The lane kernel at L = 1 gives the same bits but ran the sum 1.64x
//     slower (1.22x with L = 1 known at compile time) and min_u32 1.13x
//     (1.06x), H100 SXM, RMAT scale 20 (tools/kernel_arm_times.py), so one
//     lane keeps its own lean fold.
//   * Lanes are there for bandwidth: each thread decodes its slot's word
//     (and reads its weight) ONCE and then updates all of its block's
//     lanes, so the word stream is read once per launch whatever L is. The
//     payload (G = p * sub_size rows of L values) stays in device memory
//     and is read through the read-only cache (at L = 1 it lives in L2 for
//     the whole launch); only the vb x Lc accumulator is in shared memory
//     (sum also stages 256 x Lc lane values). Where that does not fit one
//     block (at vb = 1024 from L = 45 on for sum, L = 57 for min/or), the
//     lanes are split into chunks of Lc over a third grid dimension; each
//     chunk re-reads its tiles' words, so a launch reads the word stream
//     ceil(L / Lc) times. The launcher picks Lc from the layouts below
//     (gather_reduce_cores_lane_chunk reports it).
//   * min: one shared-memory atomicMin per slot and lane. uint32 labels use
//     it directly; float32 values are mapped to an order-preserving uint32
//     key first. or: one atomicOr per slot and lane. Folding each same-row
//     group in shared memory first ran 1.4x faster at L = 16 but 2.4x slower
//     on one packed word and 1.25x slower at 32 lanes a chunk (H100 SXM,
//     RMAT scale 20), and moved no engine run.
//   * sum: deterministic, so that PageRank and PPR give the same bits on
//     every run. Within a warp, threads that hit the same row are grouped
//     with __match_any_sync and their values added in thread order (with
//     lanes, the group's members split the lanes, each adding its lane over
//     the peers). The per-warp partials are staged in shared memory and
//     added to the accumulator warp by warp, one warp's leaders (distinct
//     rows) at a time. The order of every float add is therefore fixed by
//     the slot order alone, and one lane of the lane kernel adds in the
//     same order as the one-lane kernel.
//   * Rows no edge reaches keep the identity, which is what the level-2
//     split-row fold relies on for spare virtual rows.
// The wrapper (kernel.py) checks shapes and types before it calls the
// launcher; the launcher returns a CUDA error code (cudaErrorInvalidValue
// when not even one lane of vb rows fits a block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMin = 0;
constexpr int kSum = 1;
constexpr int kOr = 2;

__device__ __forceinline__ uint32_t f32_key(uint32_t bits) {
  // order-preserving map float -> uint32 (negative floats reversed)
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_f32(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

// List the tiles that run among kThreads candidates from t0 (the static arm
// takes t < n_cand, the dynamic arm tests fetch[t] == t) into tiles[], in
// tile order, and return how many. Every thread of the block calls it.
__device__ __forceinline__ int list_running_tiles(int t0, int n_cand,
                                                  const int32_t* fetch_blk,
                                                  int* tiles, int* warp_n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  return n_run;
}

// Decode the slot at `at`: its row in the block and its source; false for
// a padding slot.
__device__ __forceinline__ bool decode_slot(const int32_t* __restrict__ word,
                                            const int32_t* __restrict__ word_hi,
                                            long long at, int& row, int& src) {
  const int32_t w0 = __ldg(word + at);
  if (word_hi != nullptr) {
    const int32_t hi = __ldg(word_hi + at);
    row = hi & 0x7FFFFFFF;
    src = w0;
    return hi < 0;
  }
  row = (w0 >> 16) & 0x7FFF;
  src = w0 & 0xFFFF;
  return w0 < 0;
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
    // n_slots is the same for every thread, so every thread runs every step
    // and the block-wide barriers below are safe.
    const int n_slots = list_running_tiles(t0, n_cand, fetch_blk, tiles, warp_n) * eb;
    for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
      const int s = s0 + tid;
      bool valid = false;
      int row = 0;
      uint32_t v = 0;
      if (s < n_slots) {
        const long long at = base + (long long)tiles[s / eb] * eb + s % eb;
        int src;
        valid = decode_slot(word, word_hi, at, row, src);
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
      if (kind == kOr) {
        if (valid && v != 0u) atomicOr(acc + row, v);
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

__global__ void __launch_bounds__(kThreads) gather_reduce_cores_lanes_kernel(
    const uint32_t* __restrict__ payload,  // (G, L) uint32 or float32 bits
    const int32_t* __restrict__ word,      // (p, R, T, Eb)
    const int32_t* __restrict__ word_hi,   // (p, R, T, Eb) or null (16-bit)
    const float* __restrict__ weights,     // (p, R, T, Eb) or null
    const int32_t* __restrict__ counts,    // (p, R) real tiles per row block
    const int32_t* __restrict__ fetch,     // (p, R, T) fetch map or null
    uint32_t* __restrict__ out,            // (p, R * vb, L)
    int r_blocks, int t_tiles, int eb, int vb, int lanes, int lane_chunk,
    int kind, int is_f32, int add, uint32_t identity) {
  extern __shared__ uint32_t smem[];
  const int l0 = blockIdx.z * lane_chunk;
  const int nl = min(lane_chunk, lanes - l0);  // lanes of this block's chunk
  uint32_t* acc = smem;                                      // vb x nl
  int* tiles = reinterpret_cast<int*>(smem + (size_t)vb * lane_chunk);  // kThreads
  int* warp_n = tiles + kThreads;                            // kWarps
  int* st_row = warp_n + kWarps;                             // kThreads (sum)
  float* st_val = reinterpret_cast<float*>(st_row + kThreads);  // kThreads x nl (sum)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = (long long)blockIdx.y * r_blocks + blockIdx.x;
  const bool min_f32 = (kind == kMin) && is_f32;

  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  for (int j = tid; j < vb * nl; j += kThreads) acc[j] = init;
  __syncthreads();

  const long long base = blk * (long long)t_tiles * eb;
  const float ident_f = __uint_as_float(identity);
  const int32_t* fetch_blk = fetch != nullptr ? fetch + blk * t_tiles : nullptr;
  const int n_cand = fetch != nullptr ? t_tiles : counts[blk];

  for (int t0 = 0; t0 < n_cand; t0 += kThreads) {
    const int n_slots = list_running_tiles(t0, n_cand, fetch_blk, tiles, warp_n) * eb;
    for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
      const int s = s0 + tid;
      bool valid = false;
      int row = 0;
      float step = 1.0f;
      const uint32_t* prow = payload;
      if (s < n_slots) {  // decode the slot once, for every lane
        const long long at = base + (long long)tiles[s / eb] * eb + s % eb;
        int src;
        valid = decode_slot(word, word_hi, at, row, src);
        if (valid) {
          prow = payload + (long long)src * lanes + l0;
          if (add && weights != nullptr) step = __ldg(weights + at);
        }
      }
      if (kind != kSum) {
        if (!valid) continue;
        uint32_t* cell = acc + row * nl;
        for (int l = 0; l < nl; ++l) {
          uint32_t v = __ldg(prow + l);
          if (kind == kOr) {
            if (v != 0u) atomicOr(cell + l, v);
            continue;
          }
          if (add) {  // saturating min-plus map; the slot's weight on every lane
            const float x = __uint_as_float(v);
            v = __float_as_uint(x >= ident_f ? ident_f : x + step);
          }
          atomicMin(cell + l, min_f32 ? f32_key(v) : v);
        }
        continue;
      }
      // deterministic sum: the peer groups (same row) are those of every
      // lane. The group's members split its lanes (member of rank r takes
      // lanes r, r + size, ...) and each adds its lane over the peers in
      // thread order, leaving the partial in the leader's slot: a lane of
      // the leader's slot is read and written by one member only.
      if (valid) {
        float* mine = st_val + tid * nl;
        for (int l = 0; l < nl; ++l) mine[l] = __uint_as_float(__ldg(prow + l));
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, valid ? row : -1 - lane);
      __syncwarp();
      const int first = __ffs(peers) - 1;
      const int size = __popc(peers);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const bool leader = valid && lane == first;
      if (valid) {
        float* lead = st_val + ((warp << 5) + first) * nl;
        for (int l = rank; l < nl; l += size) {
          float part = 0.0f;  // the leader is the lowest thread: it is read first
          for (unsigned m = peers; m != 0; m &= m - 1) {
            part += st_val[((warp << 5) + __ffs(m) - 1) * nl + l];
          }
          lead[l] = part;
        }
      }
      st_row[tid] = leader ? row : -1;
      __syncthreads();
      float* accf = reinterpret_cast<float*>(acc);
      for (int w = 0; w < kWarps; ++w) {
        // one warp's leaders own distinct rows: no two items share a cell
        for (int i = tid; i < 32 * nl; i += kThreads) {
          const int sl = (w << 5) + i / nl;
          const int rr = st_row[sl];
          if (rr >= 0) accf[rr * nl + i % nl] += st_val[sl * nl + i % nl];
        }
        __syncthreads();
      }
    }
    __syncthreads();  // the tile list and warp counts are rewritten next chunk
  }
  __syncthreads();

  for (int j = tid; j < vb * nl; j += kThreads) {
    const long long row = blk * vb + j / nl;
    out[row * lanes + l0 + j % nl] = min_f32 ? key_f32(acc[j]) : acc[j];
  }
}

// Shared memory of the one-lane kernel for vb rows: the accumulator, the
// sum's staged values, leader rows and partials, the tile list and the
// warp counts.
size_t one_lane_smem_bytes(int vb) {
  return sizeof(uint32_t) * ((size_t)vb + 4 * kThreads + kWarps);
}

// Shared memory of the lane kernel for vb rows and a chunk of lc lanes: the
// accumulator, the tile list and the warp counts; sum adds the leader rows
// and the staged lane values of every thread.
size_t lanes_smem_bytes(int vb, int lc, int kind) {
  size_t words = (size_t)vb * lc + kThreads + kWarps;
  if (kind == kSum) words += kThreads + (size_t)kThreads * lc;
  return sizeof(uint32_t) * words;
}

}  // namespace

extern "C" {

// Lanes one block accumulates on the current device: 1 for one lane when
// the one-lane kernel's rows fit; else all the lanes when their accumulator
// fits one block's shared memory, or the even split into the fewest chunks
// that fit. 0 when not even one lane fits.
int gather_reduce_cores_lane_chunk(int vb, int lanes, int kind) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  if (lanes == 1) return one_lane_smem_bytes(vb) <= (size_t)limit ? 1 : 0;
  const size_t fixed = lanes_smem_bytes(vb, 0, kind);
  const size_t per_lane = lanes_smem_bytes(vb, 1, kind) - fixed;
  if (lanes < 1 || fixed + per_lane > (size_t)limit) return 0;
  const int most = (int)(((size_t)limit - fixed) / per_lane);
  const int chunks = (lanes + most - 1) / most;
  return (lanes + chunks - 1) / chunks;
}

int gather_reduce_cores_launch(const void* payload, const void* word,
                               const void* word_hi, const void* weights,
                               const void* counts, const void* fetch,
                               void* out, int p, int r_blocks, int t_tiles,
                               int eb, int vb, int lanes, int kind, int is_f32,
                               int add, uint32_t identity, void* stream) {
  if (p == 0 || r_blocks == 0) return 0;
  const int lane_chunk = gather_reduce_cores_lane_chunk(vb, lanes, kind);
  if (lane_chunk == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pay = (const uint32_t*)payload;
  const int32_t* w = (const int32_t*)word;
  const int32_t* w_hi = (const int32_t*)word_hi;
  const float* wts = (const float*)weights;
  const int32_t* cnt = (const int32_t*)counts;
  const int32_t* fm = (const int32_t*)fetch;
  cudaError_t err;
  if (lanes == 1) {
    const size_t smem = one_lane_smem_bytes(vb);
    err = cudaFuncSetAttribute(gather_reduce_cores_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_reduce_cores_kernel<<<dim3(r_blocks, p), kThreads, smem, s>>>(
        pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, r_blocks, t_tiles, eb, vb,
        kind, is_f32, add, identity);
  } else {
    const size_t smem = lanes_smem_bytes(vb, lane_chunk, kind);
    err = cudaFuncSetAttribute(gather_reduce_cores_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (lanes + lane_chunk - 1) / lane_chunk;
    gather_reduce_cores_lanes_kernel<<<dim3(r_blocks, p, chunks), kThreads, smem, s>>>(
        pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, r_blocks, t_tiles, eb, vb,
        lanes, lane_chunk, kind, is_f32, add, identity);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
