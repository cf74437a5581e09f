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
// What bounds it: bytes, and the atomics into a random row per slot. Each
// slot of a tile that runs is read once (4 B of word, plus 4 B of word_hi
// and 4 B of weight where streamed); the output (p x num_rows x L words)
// is written once with the identity and then lowered in place; each slot
// reads the L lanes of its source's payload row (L2) and of its
// destination's output row, and sends an atomic for each lane it lowers.
// On the smoke's partition (H100 SXM at 700 W, RMAT scale 20,
// tools/kernel_arm_times.py) the laneless arms take 6-7x their byte bound:
// a quarter to a third of their time is the atomics (the scatter_no_atomics
// variant of tools/arm_variants.py ran min_u32 in 0.032 against 0.044 ms),
// the rest the dependent chain of each slot (word, payload, output row).
// At L = 16 (0.126 ms, 4.4x) the output is 64 MiB, more than the 50 MB L2,
// the rows a slot touches are random, and the atomics are 40% of the time.
//
// Design:
//   * The accumulator is the whole per-core label row. The TPU keeps it in
//     VMEM across the (B, Tp) sweep; here one core's row is up to 1 MiB a
//     lane (Vl = 262,144), more than a block's shared memory, so the output
//     in device memory is the accumulator. A fill kernel writes the identity
//     (16-B stores) and the scatter kernel lowers it with global atomics.
//     Min and OR are order-free, so the result does not depend on the order
//     of the atomics. (Filling and scattering one core at a time, so that a
//     core's 16 MiB of rows stay in L2 at L = 16, measured slower.)
//   * Float min without keys: the output holds float32 bits, and a value
//     goes out as a signed atomicMin on its bits when its sign bit is clear
//     and an unsigned atomicMax when it is set. For every bit pattern this
//     is the min in the order of f32_key (negative floats reversed, -0.0
//     below +0.0), so no pass maps keys to floats and back. The branch is
//     on the sign bit, not on v >= 0.0f: -0.0 must take the unsigned max.
//   * Parallel over tiles, not over (core, block): with one source block per
//     core a (p, B) grid would be 4 blocks for 132 SMs. Each warp takes the
//     candidate tiles warp, warp + W, warp + 2W, ... (W warps in the grid);
//     its 32 lanes test 32 candidates with one load (counts or fetch map)
//     and a ballot, and the warp then walks the tiles that run.
//   * One lane (a laneless payload, or one packed reach word): the warp
//     walks a tile 32 slots at a time, one a lane, each slot's loads one
//     after the other. It needs few registers, so an SM holds 64 warps.
//     The lane kernel below built for one lane (G = 1: 4 slots a lane in
//     flight, 74 registers, 24 warps an SM) took 0.053 ms for min_u32,
//     slower than this kernel's 0.044 and the earlier scatter's 0.051.
//   * Lanes (L >= 2), thread groups per slot: a group of G threads owns a
//     slot's lanes, each thread a 16-B quad of lanes (L % 4 == 0) or one
//     lane, up to two such items (G = 4 at L = 16, 8 with two quads at L =
//     64; wider payloads take several lane passes). A warp reads a tile 128
//     slots a pass, each lane 4 consecutive slots with 16-B loads of word,
//     word_hi and weight (streaming: evict-first), decoded once; a group
//     walks the 4G consecutive slots its own lanes decoded, their words
//     shared with __shfl_sync, 4 slots at a time, and issues the 4 slots'
//     payload and output-row loads (16-B ld.global.cg of the cell, the skip
//     test of 4 lanes at once) before its first atomic.
//   * Source runs: inside a source block the slots are sorted by (src,
//     dst), so a group keeps the payload row in registers along a run of
//     one source and loads it again only when the source changes.
//   * Skip test: an atomic goes out only for a lane whose value is below
//     the cell as read (min) or holds bits the cell lacks (OR). The row
//     only decreases (gains bits) while the kernel runs, so a stale read
//     never skips an atomic that would have changed it; on hub rows most
//     atomics are skipped. The atomics' results are unused (RED).
// The wrapper (scatter.py) checks shapes and types before it calls the
// launcher; the launcher returns a CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t f32_key(uint32_t bits) {
  // order-preserving map float -> uint32 (negative floats reversed)
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// Lower the output cell (read as c) by the mapped value x.
__device__ __forceinline__ void lower_cell(uint32_t* cell, uint32_t x, uint32_t c, int is_or,
                                           int is_f32) {
  if (is_or) {
    if ((x & ~c) != 0u) atomicOr(cell, x);
  } else if (is_f32) {
    if (f32_key(x) < f32_key(c)) {
      if (x & 0x80000000u) {
        atomicMax(cell, x);  // negative: more negative is larger as uint32
      } else {
        atomicMin(reinterpret_cast<int*>(cell), (int)x);  // positive: int order
      }
    }
  } else if (x < c) {
    atomicMin(cell, x);
  }
}

__global__ void scatter_reduce_cores_fill_kernel(uint32_t* __restrict__ out, long long n,
                                                 uint32_t value) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // words before the first 16-B boundary, then 16-B stores, then the tail
  long long head = (long long)((16u - ((uintptr_t)out & 15u)) & 15u) / 4;
  head = head < n ? head : n;
  const long long n4 = (n - head) / 4;
  if (first < head) out[first] = value;
  uint4* out4 = reinterpret_cast<uint4*>(out + head);
  const uint4 v = make_uint4(value, value, value, value);
  for (long long i = first; i < n4; i += stride) out4[i] = v;
  for (long long i = head + n4 * 4 + first; i < n; i += stride) out[i] = value;
}

// One lane: a laneless (G,) payload or one packed reach word. A warp takes
// one tile at a time, its lanes the slots lane, lane + 32, ... one after
// the other (coalesced 4-B loads): few registers, so every SM holds 64
// warps, which measured faster here than more slots in flight a warp.
__global__ void __launch_bounds__(kThreads) scatter_reduce_cores_one_kernel(
    const uint32_t* __restrict__ payload,  // (G,) uint32 or float32 bits
    const int32_t* __restrict__ word,      // (p, B, Tp, Eb)
    const int32_t* __restrict__ word_hi,   // (p, B, Tp, Eb) or null (16-bit)
    const float* __restrict__ weights,     // (p, B, Tp, Eb) or null
    const int32_t* __restrict__ counts,    // (p, B) real tiles per source block
    const int32_t* __restrict__ fetch,     // (p, B, Tp) fetch map or null
    uint32_t* __restrict__ out,            // (p, num_rows)
    int n_tiles, int t_tiles, int b_blocks, int eb, int num_rows, int is_or, int is_f32,
    int add, uint32_t identity) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  const float ident_f = __uint_as_float(identity);

  for (int first = warp; first < n_tiles; first += 32 * n_warps) {
    // the run test of the warp's next 32 candidate tiles, one a lane
    const int mine = first + lane * n_warps;
    bool runs = false;
    if (mine < n_tiles) {
      const int cb = mine / t_tiles;  // c * B + b
      runs = fetch != nullptr ? __ldg(fetch + mine) == mine - cb * t_tiles
                              : mine - cb * t_tiles < __ldg(counts + cb);
    }
    for (unsigned todo = __ballot_sync(kAll, runs); todo != 0u; todo &= todo - 1u) {
      const int tile = first + (__ffs(todo) - 1) * n_warps;
      uint32_t* out_c = out + (long long)(tile / (t_tiles * b_blocks)) * num_rows;
      const long long base = (long long)tile * eb;
      for (int e = lane; e < eb; e += 32) {
        const int32_t w0 = __ldcs(word + base + e);
        bool valid;
        int dst, src;
        if (word_hi != nullptr) {
          const int32_t hi = __ldcs(word_hi + base + e);
          valid = hi < 0;
          dst = hi & 0x7FFFFFFF;
          src = w0;
        } else {
          valid = w0 < 0;
          dst = (w0 >> 16) & 0x7FFF;
          src = w0 & 0xFFFF;
        }
        if (!valid) continue;
        uint32_t v = __ldg(payload + src);
        if (add) {  // saturating min-plus map; no weights = unit weights
          const float step_w = weights != nullptr ? __ldcs(weights + base + e) : 1.0f;
          const float x = __uint_as_float(v);
          v = __float_as_uint(x >= ident_f ? ident_f : x + step_w);
        }
        lower_cell(out_c + dst, v, __ldcg(out_c + dst), is_or, is_f32);
      }
    }
  }
}

// A group of G threads owns one slot's lanes: thread gt of the group holds
// the lane items gt + G * i (i < kItems), each kVec lanes wide, of a lane
// pass of G * kItems * kVec lanes.
template <int G, int kVec, int kItems>
__global__ void __launch_bounds__(kThreads) scatter_reduce_cores_kernel(
    const uint32_t* __restrict__ payload,  // (G, L) uint32 or float32 bits
    const int32_t* __restrict__ word,      // (p, B, Tp, Eb)
    const int32_t* __restrict__ word_hi,   // (p, B, Tp, Eb) or null (16-bit)
    const float* __restrict__ weights,     // (p, B, Tp, Eb) or null
    const int32_t* __restrict__ counts,    // (p, B) real tiles per source block
    const int32_t* __restrict__ fetch,     // (p, B, Tp) fetch map or null
    uint32_t* __restrict__ out,            // (p, num_rows, L)
    int n_tiles, int t_tiles, int b_blocks, int eb, int num_rows, int lanes, int is_or,
    int is_f32, int add, uint32_t identity, int vec_loads) {
  constexpr int kSlots = 4 * G;  // consecutive slots a group walks a pass
  constexpr int kSub = 4;        // slots whose loads are in flight together
  constexpr int kPass = G * kItems * kVec;  // lanes of one lane pass
  const int lane = threadIdx.x & 31;
  const int g0 = lane - lane % G;  // the group's first lane
  const int gt = lane % G;         // the thread within it
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  const float ident_f = __uint_as_float(identity);
  const bool use_w = add && weights != nullptr;

  for (int first = warp; first < n_tiles; first += 32 * n_warps) {
    // the run test of the warp's next 32 candidate tiles, one a lane
    const int mine = first + lane * n_warps;
    bool runs = false;
    if (mine < n_tiles) {
      const int cb = mine / t_tiles;  // c * B + b
      runs = fetch != nullptr ? __ldg(fetch + mine) == mine - cb * t_tiles
                              : mine - cb * t_tiles < __ldg(counts + cb);
    }
    for (unsigned todo = __ballot_sync(kAll, runs); todo != 0u; todo &= todo - 1u) {
      const int tile = first + (__ffs(todo) - 1) * n_warps;
      uint32_t* out_c = out + (long long)(tile / (t_tiles * b_blocks)) * num_rows * lanes;
      const long long base = (long long)tile * eb;
      for (int e0 = 0; e0 < eb; e0 += 128) {
        // this lane's 4 consecutive slots, decoded once: dst -1 is padding
        int dst[4], src[4];
        float w[4];
        const int e = e0 + 4 * lane;
        int32_t w0[4] = {0, 0, 0, 0}, w1[4] = {0, 0, 0, 0};
        float wf[4] = {1.0f, 1.0f, 1.0f, 1.0f};
        if (vec_loads) {  // eb % 4 == 0 and 16-B aligned streams
          if (e < eb) {
            const int4 q = __ldcs(reinterpret_cast<const int4*>(word + base + e));
            w0[0] = q.x, w0[1] = q.y, w0[2] = q.z, w0[3] = q.w;
            if (word_hi != nullptr) {
              const int4 h = __ldcs(reinterpret_cast<const int4*>(word_hi + base + e));
              w1[0] = h.x, w1[1] = h.y, w1[2] = h.z, w1[3] = h.w;
            }
            if (use_w) {
              const float4 f = __ldcs(reinterpret_cast<const float4*>(weights + base + e));
              wf[0] = f.x, wf[1] = f.y, wf[2] = f.z, wf[3] = f.w;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (e + i < eb) {
              w0[i] = __ldcs(word + base + e + i);
              if (word_hi != nullptr) w1[i] = __ldcs(word_hi + base + e + i);
              if (use_w) wf[i] = __ldcs(weights + base + e + i);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool valid;
          if (word_hi != nullptr) {
            valid = w1[i] < 0;
            dst[i] = w1[i] & 0x7FFFFFFF;
            src[i] = w0[i];
          } else {
            valid = w0[i] < 0;
            dst[i] = (w0[i] >> 16) & 0x7FFF;
            src[i] = w0[i] & 0xFFFF;
          }
          if (!valid || e + i >= eb) dst[i] = -1;
          w[i] = wf[i];
        }

        for (int l0 = 0; l0 < lanes; l0 += kPass) {
          int cur_src = -1;  // the source whose payload row `pay` holds
          uint32_t pay[kItems][kVec];
#pragma unroll
          for (int it = 0; it < kItems; ++it) {
#pragma unroll
            for (int v = 0; v < kVec; ++v) pay[it][v] = 0u;
          }
#pragma unroll
          for (int s0 = 0; s0 < kSlots; s0 += kSub) {
            int b_dst[kSub];
            uint32_t b_val[kSub][kItems][kVec], b_cell[kSub][kItems][kVec];
#pragma unroll
            for (int j = 0; j < kSub; ++j) {
              // slot s0 + j of the group: decoded by lane g0 + (s0 + j) / 4
              const int i = s0 + j;
              int d, s;
              float ww;
              if (G == 1) {
                d = dst[i & 3];
                s = src[i & 3];
                ww = w[i & 3];
              } else {
                d = __shfl_sync(kAll, dst[i & 3], g0 + (i >> 2));
                s = __shfl_sync(kAll, src[i & 3], g0 + (i >> 2));
                ww = __shfl_sync(kAll, w[i & 3], g0 + (i >> 2));
              }
              b_dst[j] = d;
              const uint32_t* prow = payload + (long long)s * lanes + l0;
              uint32_t* crow = out_c + (long long)(d < 0 ? 0 : d) * lanes + l0;
              const bool reload = d >= 0 && s != cur_src;
              if (d >= 0) cur_src = s;
#pragma unroll
              for (int it = 0; it < kItems; ++it) {
                const int l = (gt + G * it) * kVec;
                const bool live = d >= 0 && l0 + l < lanes;
                if (kVec == 4) {
                  if (reload && live) {
                    const uint4 q = __ldg(reinterpret_cast<const uint4*>(prow + l));
                    pay[it][0] = q.x, pay[it][1] = q.y, pay[it][2] = q.z, pay[it][3] = q.w;
                  }
                  uint4 c = make_uint4(0u, 0u, 0u, 0u);
                  if (live) c = __ldcg(reinterpret_cast<const uint4*>(crow + l));
                  b_cell[j][it][0] = c.x, b_cell[j][it][1] = c.y;
                  b_cell[j][it][2] = c.z, b_cell[j][it][3] = c.w;
                } else {
                  if (reload && live) pay[it][0] = __ldg(prow + l);
                  b_cell[j][it][0] = live ? __ldcg(crow + l) : 0u;
                }
#pragma unroll
                for (int v = 0; v < kVec; ++v) {
                  uint32_t x = pay[it][v];
                  if (add) {  // saturating min-plus map; the slot's weight on every lane
                    const float f = __uint_as_float(x);
                    x = __float_as_uint(f >= ident_f ? ident_f : f + ww);
                  }
                  b_val[j][it][v] = x;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kSub; ++j) {
              if (b_dst[j] < 0) continue;
              uint32_t* crow = out_c + (long long)b_dst[j] * lanes + l0;
#pragma unroll
              for (int it = 0; it < kItems; ++it) {
                const int l = (gt + G * it) * kVec;
                if (l0 + l >= lanes) continue;
#pragma unroll
                for (int v = 0; v < kVec; ++v) {
                  lower_cell(crow + l + v, b_val[j][it][v], b_cell[j][it][v], is_or, is_f32);
                }
              }
            }
          }
        }
      }
    }
  }
}

// The scatter kernel's shape for L lanes: lane items of 4 lanes (16-B
// loads) when L % 4 == 0, else of one lane; G threads a slot (a power of two
// up to 8) holding at most 2 items each; wider payloads take several lane
// passes of G * items * vec lanes.
struct LaneShape {
  int vec, group, items;
};

LaneShape lane_shape(int lanes) {
  const int vec = lanes % 4 == 0 ? 4 : 1;
  const int units = lanes / vec;
  const int group = units <= 1 ? 1 : units <= 2 ? 2 : units <= 4 ? 4 : 8;
  return {vec, group, units <= 8 ? 1 : 2};
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Blocks for n threads, at most per_sm resident blocks on each SM of the
// current device (its SM count read once: the port runs on one card).
int grid_for(long long n, int per_sm) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

// Blocks of a kernel that stay resident on one SM.
template <class Kernel>
int resident_blocks(Kernel kern) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, 0) == cudaSuccess
             ? n : 1;
}

template <int G, int kVec, int kItems>
cudaError_t launch_lanes(const uint32_t* pay, const int32_t* w, const int32_t* w_hi,
                         const float* wts, const int32_t* cnt, const int32_t* fm, uint32_t* out,
                         int n_tiles, int t_tiles, int b_blocks, int eb, int num_rows, int lanes,
                         int is_or, int is_f32, int add, uint32_t identity, int vec_loads,
                         cudaStream_t s) {
  auto kern = scatter_reduce_cores_kernel<G, kVec, kItems>;
  static const int per_sm = resident_blocks(kern);
  // a warp a tile, as many as stay resident
  kern<<<grid_for(n_tiles * 32, per_sm), kThreads, 0, s>>>(
      pay, w, w_hi, wts, cnt, fm, out, n_tiles, t_tiles, b_blocks, eb, num_rows, lanes, is_or,
      is_f32, add, identity, vec_loads);
  return cudaGetLastError();
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
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_core = (long long)num_rows * lanes;  // output words of one core
  if (p == 0 || n_core == 0) return 0;
  // 16-B payload loads need a 16-B aligned payload (the wrapper sees to it)
  if (lanes % 4 == 0 && !aligned16(payload)) return (int)cudaErrorMisalignedAddress;
  scatter_reduce_cores_fill_kernel<<<grid_for(n_core * p / 4, 8), kThreads, 0, s>>>(
      (uint32_t*)out, n_core * p, identity);
  const long long n_tiles = (long long)p * b_blocks * t_tiles;  // a warp each
  if (n_tiles == 0) return (int)cudaGetLastError();
  if (n_tiles * 32 > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const uint32_t* pay = (const uint32_t*)payload;
  const int32_t* w = (const int32_t*)word;
  const int32_t* w_hi = (const int32_t*)word_hi;
  const float* wts = (const float*)weights;
  const int32_t* cnt = (const int32_t*)counts;
  const int32_t* fm = (const int32_t*)fetch;
  if (lanes == 1) {
    static const int per_sm = resident_blocks(scatter_reduce_cores_one_kernel);
    scatter_reduce_cores_one_kernel<<<grid_for(n_tiles * 32, per_sm), kThreads, 0, s>>>(
        pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, (int)n_tiles, t_tiles, b_blocks, eb,
        num_rows, is_or, is_f32, add, identity);
    return (int)cudaGetLastError();
  }
  const int vec_loads = eb % 4 == 0 && aligned16(word) && aligned16(word_hi) &&
                        aligned16(weights);
  const LaneShape sh = lane_shape(lanes);
  cudaError_t err;
#define LAUNCH_LANES(G_, V_, I_)                                                           \
  launch_lanes<G_, V_, I_>(pay, w, w_hi, wts, cnt, fm, (uint32_t*)out, (int)n_tiles, t_tiles, \
                           b_blocks, eb, num_rows, lanes, is_or, is_f32, add, identity,     \
                           vec_loads, s)
  switch (sh.vec * 100 + sh.group * 10 + sh.items) {
    case 121: err = LAUNCH_LANES(2, 1, 1); break;
    case 141: err = LAUNCH_LANES(4, 1, 1); break;
    case 181: err = LAUNCH_LANES(8, 1, 1); break;
    case 182: err = LAUNCH_LANES(8, 1, 2); break;
    case 411: err = LAUNCH_LANES(1, 4, 1); break;
    case 421: err = LAUNCH_LANES(2, 4, 1); break;
    case 441: err = LAUNCH_LANES(4, 4, 1); break;
    case 481: err = LAUNCH_LANES(8, 4, 1); break;
    case 482: err = LAUNCH_LANES(8, 4, 2); break;
    default: err = cudaErrorInvalidValue;
  }
#undef LAUNCH_LANES
  return (int)err;
}

}  // extern "C"
