// One-bucket graph-core accumulator over the uncompressed edge arrays, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_gather_reduce/kernel.py
// ::gather_reduce_pallas (its pallas_call at kernel.py:200): one (core,
// phase) bucket tiled into (R, T, Eb) slots, each slot an int32 source
// index into the payload, an int32 row within its row block and a bool
// (one byte); for every row block r and valid slot e,
//   val = payload[src]        (+ weight, saturating at the identity, for 'add';
//                              no weights = unit weights)
//   out[r * vb + dstb] = reduce(out[...], val)
// from the reduce identity, by min over uint32 (BFS/WCC labels) or float32
// (SSSP, with or without the weight add) or by sum over float32
// (PageRank). A bucket with T = 0 writes the identity.
//
// What bounds it: bytes. A slot costs 1 B of valid, and a valid one 8 B of
// src and dstb (4 B more with weights) and one 4 B payload gather; one
// compare or add per valid slot. The fused engine kernel
// (gather_reduce_cores.cu) reads one packed 4 B word a slot instead: this
// kernel's stream is the uncompressed form the paper's compression
// replaces, kept for model code and as that kernel's yardstick. At the
// smoke's buckets (~2,000 slots a row block, ~260 row blocks) a launch is a
// few dependent memory latencies long, so the design aims to have every
// slot of a row block in flight at once. What bounds it now (H100 SXM at
// 700 W, tools/kernel_arm_times.py --arms bucket: min_u32 0.0080 ms,
// min_f32_add 0.0087, sum 0.0098, 4.7x, 3.8x and 5.7x the byte bound): a
// launch alone takes 0.0020 ms and one that walks no slot 0.0030-0.0040
// (the accumulator's set-up, barriers and write-out; tools/arm_variants.py
// bucket_return_at_once, bucket_empty_walk), the rest is the chain of valid
// bytes, then src and dstb, then the payload gathers.
//
// Design (the schedule of gather_reduce_cores.cu's one-lane kernel, kept in
// its own file so that kernel's bits cannot move):
//   * One thread block of kThreads per row block: blockIdx.x = r. The
//     block's T * Eb slots are cut into one contiguous range a warp, walked
//     32 * kSlots slots a step, each lane kSlots consecutive slots: their
//     valid bytes by one load, then, where any of a group of 4 is valid, its
//     src, dstb (and weights) by one 16-B load each, then every payload
//     gather of the lane's slots before the first reduce. A group whose
//     valid word is zero loads nothing else, so padding tiles cost 4 B per
//     4 slots. Where T * Eb % kSlots != 0 or an operand is not aligned,
//     scalar loads. At the smoke's buckets 256 threads a block and 16
//     slots a lane ran slower; src and dstb loaded beside the valid bytes
//     ran up to 5% faster at 2.5% padding but read every padding slot's 8 B,
//     and was not taken.
//   * float32 min folds order-preserving uint32 keys.
//   * Runs are folded in registers: the slots of one packed row form one
//     run inside a row block (prepare_tiles keeps the dst-sorted order of a
//     bucket; tests/test_torch_partition.py checks it for its layouts).
//     A run that starts and ends inside a lane is finished there; the
//     lanes' last runs are joined across the warp by a segmented inclusive
//     shuffle scan, a lane's first run takes the scanned value of the lane
//     before it, and the warp's last run is carried into its next step.
//     Each run is written once, where it ends: min by one shared atomicMin
//     (none at the identity), a sum by one add.
//   * Sum: deterministic where each row's slots form one run in the block:
//     a run inside a warp's range is added to the accumulator once, and the
//     first and last run of each range are staged and joined in warp order
//     by one thread after a block barrier, so the association of every
//     float add is set by the slot order, with no float atomics racing and
//     no __match_any_sync (tests/_bucket_order.py repeats this association
//     on the CPU; the card tests hold the kernel's bits to it). On a layout
//     where a row has several runs the adds stay right, only their order
//     (and so the last bits) may then vary.
//   * The vb-row accumulator lives in shared memory and is written once.
// The wrapper (bucket.py) checks shapes and types before it calls the
// launcher; the launcher returns a CUDA error code (cudaErrorInvalidValue
// when vb rows do not fit one block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 4;  // consecutive slots a lane takes a step (a multiple of 4)
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

// One lane's running value along a run: min keys or float sums.
__device__ __forceinline__ uint32_t fold_value(uint32_t a, uint32_t v, int kind) {
  if (kind == kMin) return min(a, v);
  return __float_as_uint(__uint_as_float(a) + __uint_as_float(v));
}

static_assert(kSlots == 4 || kSlots == 8 || kSlots == 16, "kSlots is 4, 8 or 16");

// The valid bytes of S slots, 4 to a word, by one load.
template <int S>
__device__ __forceinline__ void load_valid(const uint8_t* p, uint32_t (&w)[S / 4]) {
  if constexpr (S == 16) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else if constexpr (S == 8) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
}

__global__ void __launch_bounds__(kThreads) gather_reduce_kernel(
    const uint32_t* __restrict__ payload,  // (G,) uint32 or float32 bits
    const int32_t* __restrict__ src,       // (R, T, Eb)
    const int32_t* __restrict__ dstb,      // (R, T, Eb)
    const uint8_t* __restrict__ valid,     // (R, T, Eb)
    const float* __restrict__ weights,     // (R, T, Eb) or null
    uint32_t* __restrict__ out,            // (R * vb,)
    int n_slots, int vb, int kind, int is_f32, int add, uint32_t identity,
    int vec_loads) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int kS = kSlots;
  constexpr int kStep = 32 * kS;  // slots a warp takes a step
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                                  // vb rows
  int* st_row = reinterpret_cast<int*>(smem + vb);       // sum: 2 pieces a warp
  float* st_val = reinterpret_cast<float*>(st_row + 2 * kWarps);  // 2 kWarps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool min_f32 = (kind == kMin) && is_f32;
  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  // a run's starting value: the identity of min, +0 for a sum
  const uint32_t start = kind == kSum ? 0u : init;

  for (int j = tid; j < vb; j += kThreads) acc[j] = init;
  if (kind == kSum && lane == 0) {
    st_row[2 * warp] = st_row[2 * warp + 1] = -1;
    st_val[2 * warp] = 0.0f;
  }
  __syncthreads();

  const long long base = (long long)blockIdx.x * n_slots;
  const float ident_f = __uint_as_float(identity);
  const bool use_w = add && weights != nullptr;
  // each warp walks its own contiguous range, kStep slots (kS a lane) a step
  const int len = ((n_slots + kWarps - 1) / kWarps + kStep - 1) / kStep * kStep;
  const int s_end = min(n_slots, (warp + 1) * len);
  int carry_row = -1;  // the run open at the end of the last step
  uint32_t carry = start;
  int first_row = -1;  // sum: the row of the range's first run (-1: none yet)

  // a finished run: min by one shared atomic (none at the identity); a sum
  // is added once, the range's first run into its staged piece
  auto finish = [&](int rr, uint32_t v) {
    if (kind == kSum) {
      atomicAdd(rr == first_row ? st_val + 2 * warp : reinterpret_cast<float*>(acc) + rr,
                __uint_as_float(v));
    } else if (v != init) {
      atomicMin(acc + rr, v);
    }
  };

  for (int s = warp * len + kS * lane; s - kS * lane < s_end; s += kStep) {
    // this lane's slots s .. s + kS - 1: row in the block (-1: none) and value
    int row[kS], sv[kS];
    float wt[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      row[i] = -1;
      sv[i] = 0;
      wt[i] = 1.0f;
    }
    if (vec_loads) {  // n_slots % kS == 0: the lane's slots are all in or all out
      uint32_t vw[kS / 4];
#pragma unroll
      for (int q = 0; q < kS / 4; ++q) vw[q] = 0u;
      if (s < s_end) load_valid<kS>(valid + base + s, vw);
#pragma unroll
      for (int q = 0; q < kS / 4; ++q) {
        if (vw[q] == 0u) continue;  // 4 padding slots: nothing else is loaded
        const long long at = base + s + 4 * q;
        const int4 a = __ldcs(reinterpret_cast<const int4*>(src + at));
        const int4 b = __ldcs(reinterpret_cast<const int4*>(dstb + at));
        const int sa[4] = {a.x, a.y, a.z, a.w}, rb[4] = {b.x, b.y, b.z, b.w};
        float4 f = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        if (use_w) f = __ldcs(reinterpret_cast<const float4*>(weights + at));
        const float fw[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = ((vw[q] >> (8 * k)) & 0xFFu) != 0u;
          row[4 * q + k] = ok ? rb[k] : -1;
          sv[4 * q + k] = sa[k];
          wt[4 * q + k] = fw[k];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (s + i < s_end && valid[base + s + i]) {
          row[i] = __ldg(dstb + base + s + i);
          sv[i] = __ldg(src + base + s + i);
          if (use_w) wt[i] = __ldg(weights + base + s + i);
        }
      }
    }
    uint32_t val[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) val[i] = row[i] >= 0 ? __ldg(payload + sv[i]) : start;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (add) {  // saturating min-plus map; no weights = unit weights
        const float x = __uint_as_float(val[i]);
        val[i] = __float_as_uint(x >= ident_f ? ident_f : x + wt[i]);
      }
      if (min_f32) val[i] = f32_key(val[i]);
    }

    // fold the lane's runs: the first (head), the last (tail), and the runs
    // between them, which start and end in this lane (finished here)
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
    for (int dd = 1; dd < 32; dd <<= 1) {
      const uint32_t v_up = __shfl_up_sync(kAll, v, dd);
      const bool head_up = __shfl_up_sync(kAll, (int)head, dd) != 0;
      if (lane >= dd && !head) {
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
    // the pieces at the ranges' edges, in range order: each chain of one row
    // is added up and then once into the accumulator
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
  __syncthreads();

  uint32_t* dst = out + (long long)blockIdx.x * vb;
  for (int j = tid; j < vb; j += kThreads) {
    dst[j] = min_f32 ? key_f32(acc[j]) : acc[j];
  }
}

// Shared memory for vb rows: the accumulator and the sum's staged pieces.
size_t smem_bytes(int vb) {
  return sizeof(uint32_t) * ((size_t)vb + 4 * kWarps);
}

// The most rows one block holds on the current device; 0 on error.
int max_vb() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return (int)(((size_t)limit - smem_bytes(0)) / sizeof(uint32_t));
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

}  // namespace

extern "C" {

// The most rows (vb) one block holds on the current device; 0 on error.
int gather_reduce_max_vb(void) { return max_vb(); }

int gather_reduce_launch(const void* payload, const void* src, const void* dstb,
                         const void* valid, const void* weights, void* out,
                         int r_blocks, int n_slots, int vb, int kind, int is_f32,
                         int add, uint32_t identity, void* stream) {
  if (r_blocks == 0) return 0;
  if (vb < 1 || vb > max_vb()) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(vb);
  cudaError_t err = cudaFuncSetAttribute(
      gather_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_loads = n_slots % kSlots == 0 && aligned(src, 16) && aligned(dstb, 16) &&
                        aligned(weights, 16) && aligned(valid, kSlots);
  gather_reduce_kernel<<<r_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int32_t*)src, (const int32_t*)dstb,
      (const uint8_t*)valid, (const float*)weights, (uint32_t*)out, n_slots, vb, kind,
      is_f32, add, identity, vec_loads);
  return (int)cudaGetLastError();
}

}  // extern "C"
