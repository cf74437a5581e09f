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
// replaces, kept for model code and as that kernel's yardstick.
//
// Design (the same schedule as gather_reduce_cores.cu's one-lane kernel,
// kept in its own file so that kernel's bits cannot move):
//   * One thread block per row block: blockIdx.x = r. A loop inside the
//     block replaces the TPU grid's sequential tile axis; the block walks
//     its T * Eb slots kThreads at a time with coalesced loads. The layout
//     has no tile counts, so padding tiles are read too; a padding slot's
//     src and dstb are not loaded.
//   * min: one shared-memory atomicMin per valid slot. uint32 labels use it
//     directly; float32 values are mapped to an order-preserving uint32 key.
//   * sum: deterministic. Within a warp, slots of the same row are grouped
//     with __match_any_sync and added in lane order by the group's leader;
//     the per-warp partials are staged in shared memory and warp 0 adds
//     them to the accumulator warp by warp (one warp's leaders own distinct
//     rows). The order of every float add is fixed by the slot order.
//   * The vb-row accumulator lives in shared memory and is written once.
// The wrapper (bucket.py) checks shapes and types before it calls the
// launcher; the launcher returns a CUDA error code (cudaErrorInvalidValue
// when vb rows do not fit one block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMin = 0;

__device__ __forceinline__ uint32_t f32_key(uint32_t bits) {
  // order-preserving map float -> uint32 (negative floats reversed)
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_f32(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key;
}

__global__ void __launch_bounds__(kThreads) gather_reduce_kernel(
    const uint32_t* __restrict__ payload,  // (G,) uint32 or float32 bits
    const int32_t* __restrict__ src,       // (R, T, Eb)
    const int32_t* __restrict__ dstb,      // (R, T, Eb)
    const uint8_t* __restrict__ valid,     // (R, T, Eb)
    const float* __restrict__ weights,     // (R, T, Eb) or null
    uint32_t* __restrict__ out,            // (R * vb,)
    int n_slots, int vb, int kind, int is_f32, int add, uint32_t identity) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                                 // vb rows
  float* st_val = reinterpret_cast<float*>(smem + vb);  // kThreads
  int* st_row = reinterpret_cast<int*>(st_val + kThreads);
  float* st_part = reinterpret_cast<float*>(st_row + kThreads);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool min_f32 = (kind == kMin) && is_f32;

  const uint32_t init = min_f32 ? f32_key(identity) : identity;
  for (int j = tid; j < vb; j += kThreads) acc[j] = init;
  __syncthreads();

  const size_t base = (size_t)blockIdx.x * n_slots;
  const float ident_f = __uint_as_float(identity);
  for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
    // n_slots is the same for every thread, so every thread runs every step
    // and the block-wide barriers below are safe.
    const int s = s0 + tid;
    bool ok = false;
    int row = 0;
    uint32_t v = 0;
    if (s < n_slots && valid[base + s]) {
      ok = true;
      row = __ldg(dstb + base + s);
      v = __ldg(payload + __ldg(src + base + s));
      if (add) {  // saturating min-plus map; no weights = unit weights
        const float x = __uint_as_float(v);
        const float step = weights != nullptr ? __ldg(weights + base + s) : 1.0f;
        v = __float_as_uint(x >= ident_f ? ident_f : x + step);
      }
    }
    if (kind == kMin) {
      if (ok) atomicMin(acc + row, min_f32 ? f32_key(v) : v);
      continue;
    }
    // deterministic sum: lane-ordered within a warp, warp-ordered across
    st_val[tid] = ok ? __uint_as_float(v) : 0.0f;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? row : -1 - lane);
    __syncwarp();
    const bool leader = ok && lane == __ffs(peers) - 1;
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
        const int rr = st_row[(w << 5) + lane];
        if (rr >= 0) accf[rr] += st_part[(w << 5) + lane];
        __syncwarp();
      }
    }
    __syncthreads();
  }
  __syncthreads();

  uint32_t* dst = out + (size_t)blockIdx.x * vb;
  for (int j = tid; j < vb; j += kThreads) {
    dst[j] = min_f32 ? key_f32(acc[j]) : acc[j];
  }
}

// Shared memory for vb rows: the accumulator and the sum's staged values,
// leader rows and partials.
size_t smem_bytes(int vb) {
  return sizeof(uint32_t) * ((size_t)vb + 3 * kThreads);
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

}  // namespace

extern "C" {

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
  gather_reduce_kernel<<<r_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int32_t*)src, (const int32_t*)dstb,
      (const uint8_t*)valid, (const float*)weights, (uint32_t*)out, n_slots, vb, kind,
      is_f32, add, identity);
  return (int)cudaGetLastError();
}

}  // extern "C"
