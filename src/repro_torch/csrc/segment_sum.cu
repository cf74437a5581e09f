// Fixed-order segment sum, for Hopper (sm_90a).
//
// No TPU kernel is replaced. The reference's segment sums are
// jax.ops.segment_sum (repro/models/gnn/common.py::aggregate, GCN's
// degrees, the MoE combine in repro/models/layers.py) and the gradients XLA
// takes of jnp.take (DIN's item and category rows, the MoE dispatch) and of
// its edge softmax: deterministic scatter-adds on a TPU. On this card
// index_add_ adds with atomics in an order that changes from run to run.
// This kernel is the one sum behind all of them (kernels/segment_sum), and
// behind the embedding bag's backward (kernels/embedding_bag/kernel.py::
// launch_backward).
//
// The layout (kernels/segment_sum/ops.py::segment_layout) is a stable sort
// of the segment ids, `order`, each segment's first sorted position,
// `start` (n_runs + 1), and `marks`, the run holding every kMark-th
// position (the sorted id there): run s is positions [start[s],
// start[s + 1]), row order[p] of x at position p. Two modes:
//
//   tree (segment_sum): a run of at most CHUNK = 256 rows is folded in
//     ascending p from +0.0 in float32. A longer run is cut into chunks of
//     256 positions from its start, each chunk folded so; the chunk sums
//     are folded again in chunks of 256, until at most 256 are left, which
//     are folded last. bfloat16 output is rounded once, at the end.
//   walk (the bag's backward, float32): every run folded whole in
//     ascending p; row order[p] / div (the bag of id slot p).
//
// The plain version (kernels/segment_sum/kernel.py::fold_runs_plain over
// the tree's levels, ops.py::tree_levels) adds in the same order, so the
// bits are the same, and two launches give the same bits.
//
// What bounds it: bytes (x's rows read once, the order and starts once, the
// sums written once; one add an element), and the latency of the dependent
// loads (start, then order, then the row), so what counts is the loads in
// flight on the card. One launch a sum, from the layout alone, nothing read
// by the host:
//
//   * The run part: a lane a (run, column vector of V elements), threads
//     numbered s * (d / V) + c, so a warp covers consecutive column vectors
//     of one or a few runs. A run of at most tile_rows rows (every run in
//     the walk, or where no run is longer than CHUNK) is folded straight
//     into the output in its type, 4 or 8 row loads in flight, the adds in
//     run order. An empty run writes +0, so no fill kernel runs. Registers
//     are capped at 40 (48 for 16-B loads), so many lanes keep loads in
//     flight; at 32 the folds spilled and ran up to 1.9x slower.
//   * The tile part: positions cut into tiles of tile_rows. A run longer
//     than tile_rows has at most one chunk starting in a tile, and a tile
//     holds the starts of at most two: item A, the chunk k >= 1 of the run
//     holding the tile's first position, and item B, the run holding the
//     next tile's first position where it starts in this tile (whole up to
//     CHUNK rows, else its chunk 0). The marks name both runs: no search.
//     Many positions: a lane a (tile, column vector) folds its items in
//     registers, as the run part does, so both parts run at its register
//     count (tile_rows 256). Few positions (above kStagedPositions the card
//     is full without it; below, a chunk's latency is the time: an
//     embedding gradient, a small graph's hub): a block a few tiles of 64
//     positions (and a slab of 256 column vectors), each item's rows staged
//     into shared memory with cp.async (16, 8 or 4 B a copy, as the row and
//     base allow) through a ring of kStages stages by all the block's
//     threads, each lane folding its column vector from shared memory in
//     row order.
//   * The tree of a long run: each chunk's float32 sum goes to a scratch
//     slot; each lane's group of 256 values at each level has a ticket
//     (atomicAdd after __threadfence), and the last of the group's writers
//     to arrive folds the group, in the tree's order, into the slot of its
//     first value (the next level's), the top group into the output. Which
//     writer arrives last never changes the order. It also puts the ticket
//     back to 0, so the counters stay zero between launches on a stream (the
//     wrapper keeps them a buffer a stream).
//
// The wrapper (kernels/segment_sum/kernel.py) checks types, shapes and
// alignment and sizes the scratch and the counters from n, d and the
// vector width (no device read); the launcher sizes the grid and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;      // CHUNK: the most rows one fold of the tree adds
constexpr int kMark = 64;        // the layout marks the run of every kMark-th position
// blocks an SM at least, so at most 40 registers a thread (48 where a load
// is 16 B): the loads in flight on the card come from many lanes
template <typename T, int V> struct MinBlocks {
  static constexpr int value = V * (int)sizeof(T) >= 16 ? 5 : 6;
};
constexpr int kLevels = 3;       // a tree of < 2^31 positions has at most 3 levels of groups
constexpr int kStages = 4;       // the staging ring
constexpr int kStageBytes = 8192;
constexpr int kMaxTilesPerBlock = 4;
constexpr long long kTileBlocksWanted = 1024;
constexpr long long kStagedPositions = 1 << 20;  // the most positions a staged tree takes

struct Params {
  const void* x;
  const int64_t* order;  // (n_pos) the row of x at each position
  const int64_t* start;  // (n_runs + 1)
  const int64_t* marks;  // (n_marks) the run holding position m * kMark (tree with tiles)
  void* out;             // (n_runs, d)
  float* scratch;        // (2 * ceil(n_pos / kChunk), d) float32 chunk sums
  int* tickets;          // (ticket rows, lanes), 0 between launches
  long long n_runs, n_pos, n_marks, n_tiles, tile_blocks, run_blocks;
  long long tbase[kLevels];  // each level's first ticket row
  int d, lanes, n_slabs, copy_bytes, tiles_per_block, tile_rows;
  unsigned div;  // the walk's row order[p] / div (rows < 2^31)
};

// raw vector types: V elements of T in one load
template <typename T, int V> struct RawOf;
template <> struct RawOf<float, 1> { using type = float; };
template <> struct RawOf<float, 2> { using type = float2; };
template <> struct RawOf<float, 4> { using type = float4; };
template <> struct RawOf<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct RawOf<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct RawOf<__nv_bfloat16, 4> { using type = uint2; };
template <> struct RawOf<__nv_bfloat16, 8> { using type = uint4; };

// bfloat16 -> float32 is exact: the 16 bits become the high half
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ void unpack(float r, float* v) { v[0] = r; }
__device__ __forceinline__ void unpack(float2 r, float* v) { v[0] = r.x; v[1] = r.y; }
__device__ __forceinline__ void unpack(float4 r, float* v) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(unsigned short r, float* v) { v[0] = bf16_lo(r); }
__device__ __forceinline__ void unpack(unsigned int r, float* v) {
  v[0] = bf16_lo(r); v[1] = bf16_hi(r);
}
__device__ __forceinline__ void unpack(uint2 r, float* v) {
  v[0] = bf16_lo(r.x); v[1] = bf16_hi(r.x); v[2] = bf16_lo(r.y); v[3] = bf16_hi(r.y);
}
__device__ __forceinline__ void unpack(uint4 r, float* v) {
  v[0] = bf16_lo(r.x); v[1] = bf16_hi(r.x); v[2] = bf16_lo(r.y); v[3] = bf16_hi(r.y);
  v[4] = bf16_lo(r.z); v[5] = bf16_hi(r.z); v[6] = bf16_lo(r.w); v[7] = bf16_hi(r.w);
}

// the output: float32 as it is, bfloat16 rounded to nearest even
template <int V> __device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

template <int V> __device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned int*>(p) = bf16_pair(v[0], v[1]);
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v[0]);
  }
}

// float32 chunk sums in the scratch, through L2 only: other blocks wrote them
template <int V> __device__ __forceinline__ void load_scratch(const float* p, float* v) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int V> __device__ __forceinline__ void store_scratch(float* p, const float* v) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      __stcg(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  } else if constexpr (V == 2) {
    __stcg(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcg(p, v[0]);
  }
}

// the row of x at position pos (rows < 2^31)
__device__ __forceinline__ int row_at(const Params& p, long long pos) {
  const unsigned r = (unsigned)__ldg(p.order + pos);
  return (int)(p.div == 1 ? r : r / p.div);
}

// the run holding position m * kMark, or -1 (past the marks, or an id in no run)
__device__ __forceinline__ long long run_at_mark(const Params& p, long long m) {
  if (m >= p.n_marks) return -1;
  const long long s = __ldg(p.marks + m);
  return s >= 0 && s < p.n_runs ? s : -1;
}

// acc += x's rows at positions [lo, hi), this lane's column vector at col:
// K row loads in flight, the adds in run order (positions and rows < 2^31)
template <typename T, int V>
__device__ __forceinline__ void fold_rows(const Params& p, int col, int lo, int hi, float* acc) {
  using Raw = typename RawOf<T, V>::type;
  constexpr int K = V * sizeof(T) >= 8 ? 4 : 8;  // row loads in flight: 8 of 4 B or less
  const T* __restrict__ x = reinterpret_cast<const T*>(p.x);
  for (int p0 = lo; p0 < hi; p0 += K) {
    int row[K];  // all K positions' rows, then all K row loads in flight
#pragma unroll
    for (int u = 0; u < K; ++u) row[u] = p0 + u < hi ? row_at(p, p0 + u) : -1;
    Raw raw[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (row[u] >= 0) {
        raw[u] = __ldg(reinterpret_cast<const Raw*>(x + (size_t)row[u] * p.d + col));
      }
    }
    // in run order; past the run's end nothing is added
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (row[u] >= 0) {
        float term[V];
        unpack(raw[u], term);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += term[v];
      }
    }
  }
}

// -- the tree of a long run ---------------------------------------------------

// scratch slot of long run's chunk k, the run's first position in 256-tile
// a: chunk k starts in 256-tile a + k; a 256-tile holds the chunk starts of
// two long runs at most, and only one of them is a run's first chunk
__device__ __forceinline__ long long slot_of(long long a, long long k) {
  return 2 * (a + k) + (k == 0 ? 1 : 0);
}

// after this lane wrote value i (a chunk sum) of level 0 of the long run s,
// positions [lo, hi): the tree folded by the last arrivals, each lane its
// own column vector cv. Level l's value i sits in the slot of level 0's
// index i * kChunk^l; a group of kChunk of them (the tree's order) is
// folded by the last of its writers to arrive (its ticket: a row a group
// and level, tbase[l] + 2 * (a / kChunk^l + k0) + (k0 == 0) for the group's
// first value k0, no two groups of a level on one row, a column a lane),
// into the slot of its first: level l + 1's value. The top level's one
// group (at most kChunk values) is folded into the output. Which writer
// arrives last never changes the order, and it puts the ticket back to 0.
template <typename T, int V>
__device__ void arrive(const Params& p, int s, int lo, int hi, int i, int cv) {
  const int a = lo / kChunk;
  int cnt = (hi - lo + kChunk - 1) / kChunk, scale = 1;
  for (int level = 0;; ++level) {
    const int k0 = i / kChunk * kChunk, n_in = min(kChunk, cnt - k0);
    int* ticket = p.tickets + (p.tbase[level] + 2 * (a / scale + k0) + (k0 == 0)) * p.lanes + cv;
    __threadfence();  // this lane's value, before its arrival
    if (atomicAdd(ticket, 1) != n_in - 1) return;
    __threadfence();  // the others' values, after theirs
    *ticket = 0;      // every arrival is in: zero for the next launch
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int k = k0; k < k0 + n_in; ++k) {  // one value at a time: few registers
      float t[V];
      load_scratch<V>(p.scratch + slot_of(a, (long long)k * scale) * p.d + cv * V, t);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += t[v];
    }
    if (cnt <= kChunk) {
      store_out<V>(reinterpret_cast<T*>(p.out) + (long long)s * p.d + cv * V, acc);
      return;
    }
    store_scratch<V>(p.scratch + slot_of(a, (long long)k0 * scale) * p.d + cv * V, acc);
    i /= kChunk;
    cnt = (cnt + kChunk - 1) / kChunk;
    scale *= kChunk;
  }
}

// the items of tile t, positions [first, first + tile_rows): A (w 0), the
// chunk k >= 1 of the run holding the tile's first position that starts in
// the tile; B (w 1), the run holding the next tile's first position where
// it starts in this tile, whole up to kChunk rows, else its chunk 0. Every
// run longer than tile_rows and every chunk of one is one tile's item.
// Positions and runs < 2^31: 32-bit, so an item costs few registers.
struct Item {
  int run, lo, hi, k;  // run -1: none; k -1: the whole run
  __device__ int first() const { return k < 0 ? lo : lo + k * kChunk; }
  __device__ int last() const {
    return k < 0 || hi - lo <= (k + 1) * kChunk ? hi : lo + (k + 1) * kChunk;
  }
};

__device__ __forceinline__ Item item_of(const Params& p, int t, int w) {
  const int step = p.tile_rows / kMark, first = t * p.tile_rows;
  const int s = (int)run_at_mark(p, (long long)(t + w) * step);
  Item it{-1, 0, 0, 0};
  if (s < 0) return it;
  const int lo = (int)__ldg(p.start + s), hi = (int)__ldg(p.start + s + 1);
  if (w == 0) {
    const int k = (first - lo + kChunk - 1) / kChunk, c = lo + k * kChunk;
    if (k >= 1 && c < hi && c < first + p.tile_rows) it = Item{s, lo, hi, k};
  } else if (lo >= first && lo < first + p.tile_rows && hi - lo > p.tile_rows) {
    it = Item{s, lo, hi, hi - lo > kChunk ? 0 : -1};
  }
  return it;
}

// a folded item: chunk k's sum (k >= 0) to its scratch slot and the tree's
// arrival, or the whole run (k -1) to the output
template <typename T, int V>
__device__ __forceinline__ void finish(const Params& p, const Item& it, int cv, const float* acc) {
  if (it.k < 0) {
    store_out<V>(reinterpret_cast<T*>(p.out) + (long long)it.run * p.d + cv * V, acc);
  } else {
    store_scratch<V>(p.scratch + slot_of(it.lo / kChunk, it.k) * p.d + cv * V, acc);
    arrive<T, V>(p, it.run, it.lo, it.hi, it.k, cv);
  }
}

// -- the parts ------------------------------------------------------------------

// every run of at most tile_rows rows (every run where there is no tile
// part), folded straight into the output; an empty run writes +0 (runs
// times column vectors < 2^31)
template <typename T, int V>
__device__ void run_part(const Params& p, unsigned rb) {
  const unsigned total = (unsigned)(p.n_runs * p.lanes), stride = (unsigned)p.run_blocks * kThreads;
  for (unsigned t = rb * kThreads + threadIdx.x; t < total; t += stride) {
    const int s = (int)(t / p.lanes);
    const int cv = (int)(t - (unsigned)s * p.lanes);
    const int lo = (int)__ldg(p.start + s), hi = (int)__ldg(p.start + s + 1);
    if (p.n_tiles > 0 && hi - lo > p.tile_rows) continue;  // the tile part's
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    fold_rows<T, V>(p, cv * V, lo, hi, acc);
    store_out<V>(reinterpret_cast<T*>(p.out) + (size_t)s * p.d + cv * V, acc);
  }
}

// registers: a lane a (tile, column vector), its two items one after the
// other, folded as the run part folds
template <typename T, int V>
__device__ void tile_lane(const Params& p, long long tb) {
  const long long t = tb * kThreads + threadIdx.x;
  if (t >= p.n_tiles * p.lanes) return;
  const int tile = (int)(t / p.lanes), cv = (int)(t - (long long)tile * p.lanes);
  for (int w = 0; w < 2; ++w) {
    const Item it = item_of(p, tile, w);
    if (it.run < 0) continue;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    fold_rows<T, V>(p, cv * V, it.first(), it.last(), acc);
    finish<T, V>(p, it, cv, acc);
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  } else {  // 2 B (a bfloat16 row off a 4-B base): an ordinary load and store
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc (this thread's column vector of the slab) += x's rows rows[0..nr) in
// order, staged by the whole block; rows (at most kChunk) in shared memory,
// so issuing a stage's copies waits on no load
template <typename T, int V>
__device__ void staged_fold(const Params& p, const int* rows, int nr, int slab,
                            unsigned char* smem, float* acc) {
  using Raw = typename RawOf<T, V>::type;
  const int tid = threadIdx.x;
  const int slab_lanes = min(kThreads, p.lanes - slab * kThreads);
  const long long col0 = (long long)slab * kThreads * V;
  const int row_bytes = slab_lanes * V * (int)sizeof(T);
  const int g = p.copy_bytes;
  const int cpr = row_bytes / g;              // copies a row
  const int rps = kStageBytes / row_bytes;    // rows a stage (>= 2: a row <= 4 KB)
  const int nst = (nr + rps - 1) / rps;
  const char* xb = reinterpret_cast<const char*>(p.x) + col0 * (long long)sizeof(T);
  auto issue = [&](int st) {
    unsigned char* buf = smem + (st % kStages) * kStageBytes;
    const int r0 = st * rps, n = min(rps, nr - r0);
    for (int i = tid; i < n * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async(buf + r * row_bytes + c * g,
               xb + (long long)rows[r0 + r] * p.d * sizeof(T) + (long long)c * g, g);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of stage st landed
    __syncthreads();               // everyone's
    if (tid < slab_lanes) {
      const unsigned char* q = smem + (st % kStages) * kStageBytes + tid * V * sizeof(T);
      const int n = min(rps, nr - st * rps);
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        float term[V];
        unpack(*reinterpret_cast<const Raw*>(q + r * row_bytes), term);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += term[v];
      }
    }
    __syncthreads();  // the stage's buffer is free again
  }
}

// shared memory: a block a few tiles and a slab, its items one after
// another (the same for all its threads), each staged by all threads
template <typename T, int V>
__device__ void tile_block(const Params& p, long long tb, unsigned char* smem) {
  __shared__ int sh_rows[kChunk];
  const long long tile0 = tb / p.n_slabs * p.tiles_per_block;
  const int slab = (int)(tb % p.n_slabs);
  const int slab_lanes = min(kThreads, p.lanes - slab * kThreads);
  const int cv = slab * kThreads + threadIdx.x;
  for (int w = 0; w < 2 * p.tiles_per_block; ++w) {
    if (tile0 + (w >> 1) >= p.n_tiles) break;
    const Item it = item_of(p, (int)(tile0 + (w >> 1)), w & 1);
    if (it.run < 0) continue;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    // the item's positions: their rows into shared memory by all threads at
    // once, then staged
    const int c = it.first(), nr = it.last() - c;
    if ((int)threadIdx.x < nr) sh_rows[threadIdx.x] = row_at(p, c + threadIdx.x);
    __syncthreads();
    staged_fold<T, V>(p, sh_rows, nr, slab, smem, acc);
    if ((int)threadIdx.x < slab_lanes) finish<T, V>(p, it, cv, acc);
  }
}

template <typename T, int V, bool STAGED>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, V>::value))
    segment_sum_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the tile blocks (long runs' chunks, the longest work) first
  const long long b = blockIdx.x;
  if (b >= p.tile_blocks) {
    run_part<T, V>(p, (unsigned)(b - p.tile_blocks));
  } else if constexpr (STAGED) {
    tile_block<T, V>(p, b, smem);
  } else {
    tile_lane<T, V>(p, b);
  }
}

template <typename T, int V>
int launch(const Params& p, bool staged, cudaStream_t s) {
  const unsigned grid = (unsigned)(p.tile_blocks + p.run_blocks);
  if (staged) {
    segment_sum_kernel<T, V, true><<<grid, kThreads, (size_t)kStages * kStageBytes, s>>>(p);
  } else {
    segment_sum_kernel<T, V, false><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, d) float32 (bf16 0) or bfloat16 (1), V = vec elements a load;
// order: (n_pos) int64 rows of x in run order (row order[p] / div);
// start: (n_runs + 1) int64; out: (n_runs, d) of x's type, every element
// written. n_ctiles: ceil(n_pos / 256) for the tree where a run may exceed
// 256 rows, else 0 (every run folded whole: the walk, or short runs); then
// marks: (n_marks) int64, the run of every 64th position; scratch:
// (2 * n_ctiles, d) float32; tickets: (segment_sum_ticket_rows(n_ctiles),
// d / vec) int32, zero. copy_bytes: 16, 8, 4 or 2, dividing d's row bytes
// and x's base address.
int segment_sum_launch(const void* x, const void* order, const void* start, const void* marks,
                       void* out, void* scratch, void* tickets, long long n_runs,
                       long long n_pos, long long n_marks, long long div, int d, int bf16,
                       int vec, int copy_bytes, long long n_ctiles, void* stream) {
  if (n_runs <= 0 || d <= 0) return 0;
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  // 32-bit positions (a chunk's end included), rows and run-part threads
  if (n_pos >= 0x7FFFFFFFLL - kChunk || n_runs * (d / vec) >= 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (d % vec != 0 || div < 1 || div >= 0x7FFFFFFFLL || n_ctiles < 0 ||
      (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 4 && copy_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_ctiles > 0 && (marks == nullptr || scratch == nullptr || tickets == nullptr ||
                       n_marks < (n_pos + kMark - 1) / kMark)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.x = x;
  p.order = reinterpret_cast<const int64_t*>(order);
  p.start = reinterpret_cast<const int64_t*>(start);
  p.marks = reinterpret_cast<const int64_t*>(marks);
  p.out = out;
  p.scratch = reinterpret_cast<float*>(scratch);
  p.tickets = reinterpret_cast<int*>(tickets);
  p.n_runs = n_runs;
  p.n_pos = n_pos;
  p.n_marks = n_marks;
  p.div = (unsigned)div;
  p.d = d;
  p.lanes = d / vec;
  p.copy_bytes = copy_bytes;
  long long rows = 0;  // each level's ticket rows, its groups' slots
  for (int l = 0, scale = 1; l < kLevels; ++l, scale *= kChunk) {
    p.tbase[l] = rows;
    rows += n_ctiles > 0 ? 2 * ((n_ctiles - 1) / scale + 1) : 0;
  }
  // staged only where few positions leave the card idle without it
  const bool staged = n_ctiles > 0 && n_pos <= kStagedPositions;
  p.tile_rows = staged ? kMark : kChunk;
  p.n_tiles = n_ctiles > 0 ? (n_pos + p.tile_rows - 1) / p.tile_rows : 0;
  if (staged) {  // enough tile blocks to fill the card, at most kMaxTilesPerBlock tiles each
    p.n_slabs = (p.lanes + kThreads - 1) / kThreads;
    const long long tpb = p.n_tiles / kTileBlocksWanted;
    p.tiles_per_block = (int)(tpb < 1 ? 1 : tpb > kMaxTilesPerBlock ? kMaxTilesPerBlock : tpb);
    p.tile_blocks = (p.n_tiles + p.tiles_per_block - 1) / p.tiles_per_block * p.n_slabs;
  } else {
    p.tile_blocks = (p.n_tiles * p.lanes + kThreads - 1) / kThreads;
  }
  const long long rb = (n_runs * p.lanes + kThreads - 1) / kThreads;
  const long long room = 0x7FFFFFFFLL - p.tile_blocks;  // the run part strides the rest
  p.run_blocks = rb < room ? rb : room;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using B = __nv_bfloat16;
    switch (vec) {
      case 8: return launch<B, 8>(p, staged, s);
      case 4: return launch<B, 4>(p, staged, s);
      case 2: return launch<B, 2>(p, staged, s);
      case 1: return launch<B, 1>(p, staged, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (vec) {
    case 4: return launch<float, 4>(p, staged, s);
    case 2: return launch<float, 2>(p, staged, s);
    case 1: return launch<float, 1>(p, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
