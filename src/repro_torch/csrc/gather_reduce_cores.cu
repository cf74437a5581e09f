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
// the memory traffic. With lanes, the L-wide output (p x R x vb x L words)
// is most of the bound; the payload rows (G x L words, a few MB) are
// gathered once per slot from L2. What bounds the lane kernel now (H100
// SXM at 700 W, the smoke's partition at L = 16: min 0.086 ms, sum 0.100,
// 3.3x and 4.2x the bound): it moves about 105 B a slot (the word stream,
// a 64-B payload row from L2, the output and the accumulator's
// initialisation and write-out) at about 2.0-2.5 TB/s, with 24 warps an SM
// waiting on the L2 gathers. The one-lane kernel (min 0.016 ms, sum 0.016,
// 2.5-4.3x the bound) pays a fixed cost a launch (the launch, each block's
// accumulator set-up, tile list and write-out) beside the dependent chain
// of each step (words, payload gathers, the warp's scan).
//
// Design:
//   * One thread block per (core c, row block r): blockIdx = (r, c). A loop
//     inside the block replaces the TPU grid's sequential tile axis.
//   * The block first lists the tiles that run, kThreads candidate tiles at
//     a time: the static arm takes tiles t < counts[c, r], the dynamic arm
//     tests fetch[c, r, t] == t. A ballot and the per-warp counts compact
//     them into a shared list, then the block walks the listed tiles' slots.
//     Tiles that do not run are never loaded, the GPU form of the TPU
//     kernel's fetch elision. The run test is a property of the tile, the
//     same for every thread, so every thread runs every step and the block
//     barriers stay safe.
//   * Two kernels share the tile listing and the slot decode (device
//     helpers below) and one launcher: gather_reduce_cores_kernel for one
//     lane (a laneless (G,) payload, or one packed reach word), and
//     gather_reduce_cores_lanes_kernel for a (G, L) payload with L >= 2.
//     An earlier lane kernel run at L = 1 gave the same bits but ran the
//     sum 1.64x slower (H100 SXM, RMAT scale 20,
//     tools/kernel_arm_times.py), so one lane keeps its own kernel.
//   * One lane: the listed slots of a block are cut into one contiguous
//     range a warp, walked 128 slots a step, each lane 4 consecutive slots
//     read with 16-B loads (word, word_hi, weight; where eb % 4 != 0, four
//     scalar loads) and their 4 payload gathers issued before the fold.
//     float32 min folds order-preserving uint32 keys. The slot stream is
//     dst-sorted inside a row block (prepare_tiles keeps the sorted
//     order), so a lane folds its runs in registers: a run that starts and
//     ends inside the lane is finished there; the lanes' last runs are
//     joined across the warp by a segmented inclusive shuffle scan, a
//     lane's first run takes the scanned value of the lane before it, and
//     the warp's last run is carried into its next step. Each run is
//     written once, where it ends: min and OR by one shared atomic (none
//     at the identity), a sum by one add.
//   * One lane, sum: deterministic where each row's slots form one run in
//     the block, which every layout the port builds keeps
//     (tests/test_torch_partition.py), so that PageRank gives the same bits
//     on every run: the scan's association is set by the slot order, a run
//     inside a warp's range is added to the accumulator once, and the first
//     and last run of each range are staged and joined in warp order by one
//     thread after a block barrier. On a layout where a row has several
//     runs the adds stay right, only their order (and so the last bits) may
//     then vary from launch to launch.
//   * Lanes: a group of G threads owns one slot's lanes, each thread a
//     quad of lanes loaded as one 16-B uint4 (L % 4 == 0) or one lane (else),
//     up to two such items: at L = 16, G = 4 and 8 slots a warp
//     instruction. The listed slots of a block are cut into kThreads / G
//     contiguous stretches, one a group. A group takes its stretch a batch
//     of max(G, 4) slots at a time: each thread loads and decodes the words
//     of max(1, 4 / G) slots (word, word_hi, weight read once), the group
//     shares them with __shfl_sync, and each thread issues the payload
//     loads of the whole batch before it folds them, so several gathers are
//     in flight. The slot stream is dst-sorted inside a row block
//     (prepare_tiles keeps the sorted order), so consecutive slots share a
//     row: the group keeps the running min, OR or sum of its lanes in
//     registers along the run and writes the accumulator only when the row
//     changes and at the end of its stretch.
//   * The accumulator is vb rows of nl lanes in shared memory, each row's
//     lanes XOR-swizzled by its low bits (nl a multiple of 8) or rows an odd
//     stride apart (else), so that groups writing different rows spread over
//     the banks. Where a block cannot hold 64 lanes (16 when L % 4 != 0) or
//     what shared memory admits, the lanes are split into chunks of Lc over
//     a third grid dimension; each chunk re-reads its tiles' words, so a
//     launch reads the word stream ceil(L / Lc) times. The launcher picks
//     Lc from the layout below (gather_reduce_cores_lane_chunk reports it).
//   * Lanes, min and OR: one shared atomic per (run piece, lane), skipped
//     where the piece holds the identity. Atomics keep them exact on any
//     layout.
//   * Lanes, sum: deterministic where each row's slots form one run in the
//     block, which every layout the port builds keeps
//     (tests/test_torch_partition.py). A run that starts and ends inside a
//     group's stretch is added to the accumulator by that group alone. The
//     first and last run of each stretch are staged; after a block barrier
//     the pieces of a run that spans stretches are added together in
//     stretch order by the group where it starts, and then once into the
//     accumulator. So each (row, lane) takes one add per tile list of
//     kThreads tiles, in an order set by the slot order alone, and a rerun
//     gives the same bits. The adds are shared-memory atomicAdds: on a
//     layout where a row has several runs they stay right, only their order
//     (and so the last bits) may then vary from launch to launch.
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

// One lane's running value along a run: min keys, OR words or float sums.
__device__ __forceinline__ uint32_t fold_value(uint32_t a, uint32_t v, int kind) {
  if (kind == kMin) return min(a, v);
  if (kind == kOr) return a | v;
  return __float_as_uint(__uint_as_float(a) + __uint_as_float(v));
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
    int add, uint32_t identity, int vec_loads) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int kS = 4;            // consecutive slots a lane takes a step (16 B)
  constexpr int kStep = 32 * kS;   // slots a warp takes a step
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                                   // vb rows
  int* tiles = reinterpret_cast<int*>(smem + vb);         // kThreads
  int* warp_n = tiles + kThreads;                         // kWarps
  int* st_row = warp_n + kWarps;                          // sum: 2 pieces a warp
  float* st_val = reinterpret_cast<float*>(st_row + 2 * kWarps);  // 2 kWarps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = (long long)blockIdx.y * r_blocks + blockIdx.x;
  const bool min_f32 = (kind == kMin) && is_f32;
  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  // a run's starting value: the identity of min and OR, +0 for a sum
  const uint32_t start = kind == kSum ? 0u : init;

  for (int j = tid; j < vb; j += kThreads) acc[j] = init;
  __syncthreads();

  const long long base = blk * (long long)t_tiles * eb;
  const float ident_f = __uint_as_float(identity);
  const bool use_w = add && weights != nullptr;
  const int32_t* fetch_blk = fetch != nullptr ? fetch + blk * t_tiles : nullptr;
  // the static arm only needs to look at the first counts[c, r] tiles
  const int n_cand = fetch != nullptr ? t_tiles : counts[blk];

  for (int t0 = 0; t0 < n_cand; t0 += kThreads) {
    // n_slots is the same for every thread, so every thread runs every step
    // and the block-wide barriers below are safe.
    const int n_slots = list_running_tiles(t0, n_cand, fetch_blk, tiles, warp_n) * eb;
    // each warp walks its own contiguous range, kStep slots (kS a lane) a step
    const int len = ((n_slots + kWarps - 1) / kWarps + kStep - 1) / kStep * kStep;
    const int s_end = min(n_slots, (warp + 1) * len);
    int carry_row = -1;  // the run open at the end of the last step
    uint32_t carry = start;
    int first_row = -1;  // sum: the row of the range's first run (-1: none yet)
    if (kind == kSum && lane == 0) {
      st_row[2 * warp] = st_row[2 * warp + 1] = -1;
      st_val[2 * warp] = 0.0f;
    }
    __syncwarp();

    // a finished run: min and OR by one shared atomic (none at the identity);
    // a sum is added once, the range's first run into its staged piece
    auto finish = [&](int rr, uint32_t v) {
      if (kind == kSum) {
        atomicAdd(rr == first_row ? st_val + 2 * warp : reinterpret_cast<float*>(acc) + rr,
                  __uint_as_float(v));
      } else if (v != init) {
        if (kind == kMin) {
          atomicMin(acc + rr, v);
        } else {
          atomicOr(acc + rr, v);
        }
      }
    };

    for (int s = warp * len + kS * lane; s - kS * lane < s_end; s += kStep) {
      // this lane's slots s .. s + kS - 1: row in the block (-1: none) and value
      int row[kS], src[kS];
      float wt[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) wt[i] = 1.0f;
      if (vec_loads) {  // eb % 4 == 0: the 4 slots lie in one tile
        int4 q = make_int4(0, 0, 0, 0), h = make_int4(0, 0, 0, 0);
        if (s < s_end) {
          const long long at = base + (long long)tiles[s / eb] * eb + s % eb;
          q = __ldcs(reinterpret_cast<const int4*>(word + at));
          if (word_hi != nullptr) h = __ldcs(reinterpret_cast<const int4*>(word_hi + at));
          if (use_w) {
            const float4 f = __ldcs(reinterpret_cast<const float4*>(weights + at));
            wt[0] = f.x, wt[1] = f.y, wt[2] = f.z, wt[3] = f.w;
          }
        }
        const int32_t w0[kS] = {q.x, q.y, q.z, q.w}, w1[kS] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          if (word_hi != nullptr) {
            row[i] = w1[i] < 0 ? (w1[i] & 0x7FFFFFFF) : -1;
            src[i] = w0[i];
          } else {
            row[i] = w0[i] < 0 ? ((w0[i] >> 16) & 0x7FFF) : -1;
            src[i] = w0[i] & 0xFFFF;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          row[i] = -1;
          src[i] = 0;
          if (s + i < s_end) {
            const long long at = base + (long long)tiles[(s + i) / eb] * eb + (s + i) % eb;
            int rr, sr;
            if (decode_slot(word, word_hi, at, rr, sr)) {
              row[i] = rr;
              src[i] = sr;
              if (use_w) wt[i] = __ldg(weights + at);
            }
          }
        }
      }
      uint32_t val[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) val[i] = row[i] >= 0 ? __ldg(payload + src[i]) : start;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (add) {  // saturating min-plus map; no weights = unit weights
          const float x = __uint_as_float(val[i]);
          val[i] = __float_as_uint(x >= ident_f ? ident_f : x + wt[i]);
        }
        if (min_f32) val[i] = f32_key(val[i]);
      }

      // fold the lane's runs: the first (head), the last (tail), and the
      // runs between them, which start and end in this lane (finished here)
      int h_row = -1, t_row = -1, n_runs = 0;
      uint32_t h_val = start, t_val = start;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (row[i] < 0) continue;  // padding: the run goes on past it
        if (row[i] == t_row) {
          t_val = fold_value(t_val, val[i], kind);
          continue;
        }
        if (n_runs == 1) {
          h_row = t_row;
          h_val = t_val;
        } else if (n_runs > 1) {
          finish(t_row, t_val);
        }
        t_row = row[i];
        t_val = val[i];
        ++n_runs;
      }
      const bool has = n_runs > 0;
      const bool single = n_runs == 1;
      const int h = single ? t_row : h_row;  // the lane's first row
      if (kind == kSum && first_row < 0) {   // warp-uniform
        const unsigned any = __ballot_sync(kAll, has);
        if (any != 0u) first_row = __shfl_sync(kAll, h, __ffs(any) - 1);
      }
      // does the lane's first run go on from the lane before (lane 0: the carry)?
      const int left_t = __shfl_up_sync(kAll, t_row, 1);
      const bool joins = has && h == (lane == 0 ? carry_row : left_t);
      // segmented inclusive scan of the tail runs, left to right; a lane that
      // is one run joining its left neighbour's tail continues that run
      uint32_t v = t_val;
      bool head = !(single && joins);
      if (lane == 0) {
        if (single && joins) v = fold_value(carry, v, kind);
        head = true;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v_up = __shfl_up_sync(kAll, v, d);
        const bool head_up = __shfl_up_sync(kAll, (int)head, d) != 0;
        if (lane >= d && !head) {
          v = fold_value(v_up, v, kind);
          head = head_up;
        }
      }
      const uint32_t left_v = __shfl_up_sync(kAll, v, 1);
      const bool next_joins = __shfl_down_sync(kAll, (int)joins, 1) != 0;
      if (lane == 0 && carry_row >= 0 && !joins) finish(carry_row, carry);  // ended last step
      if (has && !single) {  // the head run ends in this lane
        finish(h_row, joins ? fold_value(lane == 0 ? carry : left_v, h_val, kind) : h_val);
      }
      if (has && lane < 31 && !next_joins) finish(t_row, v);  // the tail ends here
      carry_row = __shfl_sync(kAll, t_row, 31);
      carry = __shfl_sync(kAll, v, 31);
    }
    if (carry_row >= 0 && lane == 0) {  // the run open at the end of the range
      if (kind != kSum) {
        finish(carry_row, carry);
      } else if (carry_row == first_row) {
        atomicAdd(st_val + 2 * warp, __uint_as_float(carry));
      } else {
        st_row[2 * warp + 1] = carry_row;
        st_val[2 * warp + 1] = __uint_as_float(carry);
      }
    }

    if (kind == kSum) {
      // the pieces at the ranges' edges, in range order: each chain of one
      // row is added up and then once into the accumulator
      if (lane == 0) st_row[2 * warp] = first_row;
      __syncthreads();
      if (tid == 0) {
        float* accf = reinterpret_cast<float*>(acc);
        int rr = -1;
        float tot = 0.0f;
        for (int q = 0; q < 2 * kWarps; ++q) {
          const int r = st_row[q];
          if (r < 0) continue;
          if (r == rr) {
            tot += st_val[q];
            continue;
          }
          if (rr >= 0) accf[rr] += tot;
          rr = r;
          tot = st_val[q];
        }
        if (rr >= 0) accf[rr] += tot;
      }
    }
    __syncthreads();  // the tile list, warp counts and pieces are rewritten next
  }
  __syncthreads();

  uint32_t* dst = out + blk * vb;
  for (int j = tid; j < vb; j += kThreads) {
    dst[j] = min_f32 ? key_f32(acc[j]) : acc[j];
  }
}

// Row stride and lane swizzle of the lane kernel's accumulator for nl lanes:
// where nl is a multiple of 8, rows are nl words apart and a row's lanes
// are XOR-ed with its low bits (p - 1, p the largest power of two up to 32
// dividing nl), else rows are an odd stride apart; either way groups that
// write different rows spread over the banks.
__host__ __device__ __forceinline__ int acc_stride(int nl) {
  return (nl & -nl) >= 8 ? nl : (nl | 1);
}

__device__ __forceinline__ int acc_swizzle(int nl) {
  const int p = min(nl & -nl, 32);
  return p >= 8 ? p - 1 : 0;
}

// A group of G threads owns one slot's lanes: thread gt of the group holds
// the lane items gt + G * i (i < kItems), each kVec lanes wide.
template <int G, int kVec, int kItems>
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
  constexpr int kGroups = kThreads / G;
  constexpr int kBatch = G < 4 ? 4 : G;  // slots a group folds per batch
  constexpr int kWords = kBatch / G;     // slot words a thread loads per batch
  constexpr unsigned kAll = 0xFFFFFFFFu;
  extern __shared__ uint32_t smem[];
  const int l0 = blockIdx.z * lane_chunk;
  const int nl = min(lane_chunk, lanes - l0);  // lanes of this block's chunk
  const int units = nl / kVec;                 // lane items of this chunk
  const int stride = acc_stride(nl);
  const int swz = acc_swizzle(nl);
  uint32_t* acc = smem;  // vb x stride; lane l of row r at r * stride + (l ^ (r & swz))
  int* tiles = reinterpret_cast<int*>(smem + (size_t)vb * acc_stride(lane_chunk));  // kThreads
  int* warp_n = tiles + kThreads;                                      // kWarps
  int* st_row = warp_n + kWarps;  // sum: each group's first and last run piece
  float* st_val = reinterpret_cast<float*>(st_row + 2 * kGroups);  // 2 kGroups x lane_chunk

  const int tid = threadIdx.x;
  const int g = tid / G;   // the group
  const int gt = tid % G;  // the thread within it
  const long long blk = (long long)blockIdx.y * r_blocks + blockIdx.x;
  const bool min_f32 = (kind == kMin) && is_f32;
  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  // a run's starting value: the identity of min and OR, +0 for a sum
  const uint32_t start = kind == kSum ? 0u : init;

  for (int j = tid; j < vb * stride; j += kThreads) acc[j] = init;
  __syncthreads();

  const long long base = blk * (long long)t_tiles * eb;
  const float ident_f = __uint_as_float(identity);
  const int32_t* fetch_blk = fetch != nullptr ? fetch + blk * t_tiles : nullptr;
  const int n_cand = fetch != nullptr ? t_tiles : counts[blk];

  for (int t0 = 0; t0 < n_cand; t0 += kThreads) {
    const int n_slots = list_running_tiles(t0, n_cand, fetch_blk, tiles, warp_n) * eb;
    // every group takes the same number of batches: slots past n_slots are
    // padding, so the group's shuffles see all of its threads
    const int len = ((n_slots + kGroups - 1) / kGroups + kBatch - 1) / kBatch * kBatch;
    const int s_beg = g * len;
    int cur = -1;  // the row of the run being folded
    uint32_t run[kItems][kVec];
    int n_done = 0;  // sum: runs of the stretch already written or staged
    if (kind == kSum && gt == 0) st_row[2 * g] = st_row[2 * g + 1] = -1;

    // write the finished run of row `rr`: min and OR by atomics; a sum is
    // staged when it is the stretch's first (last: at_end) run, else added
    auto finish = [&](int rr, bool at_end) {
      uint32_t* cell = acc + rr * stride;
      const int sw = rr & swz;
      if (kind == kSum) {
        const int piece = n_done == 0 ? 0 : (at_end ? 1 : -1);
        if (piece >= 0 && gt == 0) st_row[2 * g + piece] = rr;
        float* st = st_val + (size_t)(2 * g + (piece > 0)) * lane_chunk;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int u = gt + G * i;
          if (u >= units) continue;
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            const float x = __uint_as_float(run[i][v]);
            if (piece >= 0) {
              st[u * kVec + v] = x;
            } else {
              atomicAdd(reinterpret_cast<float*>(cell) + ((u * kVec + v) ^ sw), x);
            }
          }
        }
        ++n_done;
        return;
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = gt + G * i;
        if (u >= units) continue;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const uint32_t x = run[i][v];
          if (x == init) continue;  // nothing to add to the row
          if (kind == kMin) {
            atomicMin(cell + ((u * kVec + v) ^ sw), x);
          } else {
            atomicOr(cell + ((u * kVec + v) ^ sw), x);
          }
        }
      }
    };

    for (int k = 0; k < len; k += kBatch) {
      // load and decode kWords slot words; slot j of the batch is held by
      // thread j % G of the group, in its register j / G
      int my_row[kWords], my_src[kWords];
      float my_w[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int s = s_beg + k + gt + G * i;
        my_row[i] = -1;
        my_src[i] = 0;
        my_w[i] = 1.0f;
        if (s < n_slots) {
          const long long at = base + (long long)tiles[s / eb] * eb + s % eb;
          int rr, src;
          if (decode_slot(word, word_hi, at, rr, src)) {
            my_row[i] = rr;
            my_src[i] = src;
            if (add && weights != nullptr) my_w[i] = __ldg(weights + at);
          }
        }
      }
      int b_row[kBatch];
      uint32_t b_val[kBatch][kItems][kVec];
      float b_w[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        b_row[j] = __shfl_sync(kAll, my_row[j / G], j % G, G);
        const int src = __shfl_sync(kAll, my_src[j / G], j % G, G);
        b_w[j] = add ? __shfl_sync(kAll, my_w[j / G], j % G, G) : 1.0f;
        const uint32_t* prow = payload + (long long)src * lanes + l0;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int u = gt + G * i;
          const bool live = b_row[j] >= 0 && u < units;
          if (kVec == 4) {
            uint4 q = make_uint4(0u, 0u, 0u, 0u);
            if (live) q = __ldg(reinterpret_cast<const uint4*>(prow + u * 4));
            b_val[j][i][0] = q.x;
            b_val[j][i][1] = q.y;
            b_val[j][i][2] = q.z;
            b_val[j][i][3] = q.w;
          } else {
            b_val[j][i][0] = live ? __ldg(prow + u) : 0u;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int rr = b_row[j];
        if (rr < 0) continue;  // padding: the run goes on past it
        if (rr != cur) {
          if (cur >= 0) finish(cur, false);
          cur = rr;
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
#pragma unroll
            for (int v = 0; v < kVec; ++v) run[i][v] = start;
          }
        }
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            uint32_t x = b_val[j][i][v];
            if (add) {  // saturating min-plus map; the slot's weight on every lane
              const float f = __uint_as_float(x);
              x = __float_as_uint(f >= ident_f ? ident_f : f + b_w[j]);
            }
            if (min_f32) x = f32_key(x);
            run[i][v] = fold_value(run[i][v], x, kind);
          }
        }
      }
    }
    if (cur >= 0) finish(cur, true);

    if (kind == kSum) {
      // the pieces of a run that spans stretches, in stretch order: each
      // chain of equal-row pieces is added up by the group holding its first
      // piece, then once into the accumulator
      __syncthreads();
      float* accf = reinterpret_cast<float*>(acc);
      for (int e = 0; e < 2; ++e) {
        const int p = 2 * g + e;
        const int rr = st_row[p];
        if (rr < 0) continue;
        int q = p - 1;
        while (q >= 0 && st_row[q] < 0) --q;
        if (q >= 0 && st_row[q] == rr) continue;  // not the chain's first piece
        int q_end = p + 1;
        while (q_end < 2 * kGroups && (st_row[q_end] < 0 || st_row[q_end] == rr)) ++q_end;
        for (int i = 0; i < kItems; ++i) {
          const int u = gt + G * i;
          if (u >= units) continue;
          for (int v = 0; v < kVec; ++v) {
            const int l = u * kVec + v;
            float tot = st_val[(size_t)p * lane_chunk + l];
            for (int c = p + 1; c < q_end; ++c) {
              if (st_row[c] == rr) tot += st_val[(size_t)c * lane_chunk + l];
            }
            atomicAdd(accf + rr * stride + (l ^ (rr & swz)), tot);
          }
        }
      }
    }
    __syncthreads();  // the tile list, warp counts and pieces are rewritten next
  }
  __syncthreads();

  if (kVec == 4) {  // 16-B stores of 4 lanes
    for (int j = tid; j < vb * units; j += kThreads) {
      const int rr = j / units;
      const int l = (j - rr * units) * 4;
      const uint32_t* row = acc + rr * stride;
      const int sw = rr & swz;
      uint32_t x[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        x[v] = row[(l + v) ^ sw];
        if (min_f32) x[v] = key_f32(x[v]);
      }
      *reinterpret_cast<uint4*>(out + (blk * vb + rr) * lanes + l0 + l) =
          make_uint4(x[0], x[1], x[2], x[3]);
    }
  } else {
    for (int j = tid; j < vb * nl; j += kThreads) {
      const int rr = j / nl;
      const int l = j - rr * nl;
      const uint32_t x = acc[rr * stride + (l ^ (rr & swz))];
      out[(blk * vb + rr) * lanes + l0 + l] = min_f32 ? key_f32(x) : x;
    }
  }
}

// Shared memory of the one-lane kernel for vb rows: the accumulator, the
// tile list, the warp counts and the sum's two staged pieces (row, value) a
// warp.
size_t one_lane_smem_bytes(int vb) {
  return sizeof(uint32_t) * ((size_t)vb + kThreads + kWarps + 4 * kWarps);
}

// The lane kernel's shape for a chunk of lc lanes: lane items of 4 lanes
// (16-B loads) when L % 4 == 0 and lc % 4 == 0, else of one lane; G
// threads a slot (a power of two up to 8) holding at most 2 items each.
struct LaneShape {
  int vec, group, items;
};

LaneShape lane_shape(int lanes, int lc) {
  const int vec = (lanes % 4 == 0 && lc % 4 == 0) ? 4 : 1;
  const int units = lc / vec;
  const int group = units <= 1 ? 1 : units <= 2 ? 2 : units <= 4 ? 4 : 8;
  return {vec, group, (units + group - 1) / group};
}

constexpr int kMaxLanesVec = 64;     // 8 threads x 2 items x 4 lanes
constexpr int kMaxLanesScalar = 16;  // 8 threads x 2 items x 1 lane

// Shared memory of the lane kernel for vb rows and a chunk of lc lanes: the
// accumulator at its row stride, the tile list and the warp counts; sum
// adds each group's two staged run pieces.
size_t lanes_smem_bytes(int vb, int lanes, int lc, int kind) {
  size_t words = (size_t)vb * acc_stride(lc) + kThreads + kWarps;
  if (kind == kSum) {
    const size_t groups = kThreads / lane_shape(lanes, lc).group;
    words += 2 * groups * (1 + (size_t)lc);
  }
  return sizeof(uint32_t) * words;
}

template <int G, int kVec, int kItems>
cudaError_t launch_lanes(const uint32_t* pay, const int32_t* w, const int32_t* w_hi,
                         const float* wts, const int32_t* cnt, const int32_t* fm,
                         uint32_t* out, int p, int r_blocks, int t_tiles, int eb, int vb,
                         int lanes, int lane_chunk, int kind, int is_f32, int add,
                         uint32_t identity, size_t smem, cudaStream_t s) {
  auto kern = gather_reduce_cores_lanes_kernel<G, kVec, kItems>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (lanes + lane_chunk - 1) / lane_chunk;
  kern<<<dim3(r_blocks, p, chunks), kThreads, smem, s>>>(
      pay, w, w_hi, wts, cnt, fm, out, r_blocks, t_tiles, eb, vb, lanes, lane_chunk, kind,
      is_f32, add, identity);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes one block accumulates on the current device: 1 for one lane when
// the one-lane kernel's rows fit; else all the lanes when they fit one
// block (at most 64, 16 when L % 4 != 0, and what shared memory holds), or
// the even split into the fewest chunks that fit (a multiple of 4 lanes
// when L % 4 == 0). 0 when not even one lane fits.
int gather_reduce_cores_lane_chunk(int vb, int lanes, int kind) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  if (lanes == 1) return one_lane_smem_bytes(vb) <= (size_t)limit ? 1 : 0;
  if (lanes < 1) return 0;
  const bool vec = lanes % 4 == 0;
  const int cap = min(lanes, vec ? kMaxLanesVec : kMaxLanesScalar);
  int most = 0;
  for (int lc = cap; lc >= 1 && most == 0; --lc) {  // quads first where L % 4 == 0
    if ((!vec || lc % 4 == 0) && lanes_smem_bytes(vb, lanes, lc, kind) <= (size_t)limit) {
      most = lc;
    }
  }
  for (int lc = min(cap, 3); lc >= 1 && most == 0; --lc) {
    if (lanes_smem_bytes(vb, lanes, lc, kind) <= (size_t)limit) most = lc;
  }
  if (most == 0) return 0;
  const int chunks = (lanes + most - 1) / most;
  int lc = (lanes + chunks - 1) / chunks;
  if (vec && most % 4 == 0) lc = (lc + 3) / 4 * 4;  // <= most
  return lc;
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
    // 16-B loads of 4 slots where eb % 4 == 0 and the streams are on 16 B
    const int vec_loads = eb % 4 == 0 && ((uintptr_t)w & 15u) == 0 &&
                          ((uintptr_t)w_hi & 15u) == 0 && ((uintptr_t)wts & 15u) == 0;
    gather_reduce_cores_kernel<<<dim3(r_blocks, p), kThreads, smem, s>>>(
        pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, r_blocks, t_tiles, eb, vb,
        kind, is_f32, add, identity, vec_loads);
    return (int)cudaGetLastError();
  }
  // 16-B payload loads need a 16-B aligned payload (the wrapper sees to it)
  if (lanes % 4 == 0 && ((uintptr_t)payload & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  const size_t smem = lanes_smem_bytes(vb, lanes, lane_chunk, kind);
  const LaneShape sh = lane_shape(lanes, lane_chunk);
#define LAUNCH_LANES(G_, V_, I_)                                                          \
  launch_lanes<G_, V_, I_>(pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, p, r_blocks,      \
                           t_tiles, eb, vb, lanes, lane_chunk, kind, is_f32, add,        \
                           identity, smem, s)
  const int key = sh.vec * 100 + sh.group * 10 + sh.items;
  switch (key) {
    case 411: err = LAUNCH_LANES(1, 4, 1); break;
    case 421: err = LAUNCH_LANES(2, 4, 1); break;
    case 441: err = LAUNCH_LANES(4, 4, 1); break;
    case 481: err = LAUNCH_LANES(8, 4, 1); break;
    case 482: err = LAUNCH_LANES(8, 4, 2); break;
    case 111: err = LAUNCH_LANES(1, 1, 1); break;
    case 121: err = LAUNCH_LANES(2, 1, 1); break;
    case 141: err = LAUNCH_LANES(4, 1, 1); break;
    case 181: err = LAUNCH_LANES(8, 1, 1); break;
    case 182: err = LAUNCH_LANES(8, 1, 2); break;
    default: err = cudaErrorInvalidValue;
  }
#undef LAUNCH_LANES
  return (int)err;
}

}  // extern "C"
