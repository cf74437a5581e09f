// Embedding bag (per bag, the sum or mean of table rows picked by id), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py
// ::embedding_bag_pallas (its pallas_call at kernel.py:88): table (N, D)
// float32 x ids (B, L) int32 -> out (B, D) float32. An id < 0 is padding;
// mean divides a bag's sum by max(count of real ids, 1).
//
// What bounds it: bytes. Each real id moves one row of D x 4 B (72 B at the
// published DIN width D = 18, touching 3 or 4 32-B sectors); the ids are read
// once and the output written once. One add per real id and column.
//
// Design:
//   * One warp per bag, in a grid-stride loop over the bags, so any B runs
//     (the TPU kernel asserts B % bags_per_tile == 0). The warp's lanes cover
//     the D columns in vectors of VEC floats. A row starts at id * D * 4 B, so
//     a float4 load needs D % 4 == 0 and a float2 load D % 2 == 0 (with the
//     table aligned to match): D = 18 rows are 8-B aligned, not 16-B, so
//     float2. The wrapper picks VEC; D wider than 32 * VEC walks the bag once
//     per column chunk.
//   * The warp reads 32 of the bag's ids at once (coalesced, one per lane)
//     and broadcasts them with __shfl_sync. A padding id costs no load at all
//     (the TPU kernel fetches row 0 for it and masks the add).
//   * Loads run ahead of the adds: kUnroll rows are fetched into registers
//     first, then added in id order. Several row fetches are in flight per
//     warp, and each column is still summed in the order of the ids, which is
//     the TPU kernel's order, so a rerun gives the same bits. A padding slot's
//     registers hold +0 and are added like the others: with the adds
//     predicated on the id instead, the compiler issued the last fetch of
//     each group only after the first row's adds, which wait for that row.
//   * The count of real ids for mean is kept in the same walk.
//   * Row offsets are 64-bit: the DIN item table has 10,000,384 rows.
// Ids must be < N; the wrapper cannot check that without reading them back.
// The wrapper (kernels/embedding_bag/kernel.py) checks shapes and types; the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks of 256 on each SM
constexpr int kUnroll = 8;           // row fetches in flight per warp; divides 32

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC, bool MEAN>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, int n_bags, int length, int d) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int bag = blockIdx.x * kWarps + (threadIdx.x >> 5); bag < n_bags;
       bag += n_warps) {  // the same bag for every lane of the warp
    const int32_t* bag_ids = ids + (long long)bag * length;
    for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
      const int col = c0 + lane * VEC;
      const bool active = col < d;  // d % VEC == 0: a vector is all in or out
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      int count = 0;
      for (int i0 = 0; i0 < length; i0 += 32) {
        const int32_t mine = i0 + lane < length ? __ldg(bag_ids + i0 + lane) : -1;
        const int n = min(32, length - i0);
        for (int j0 = 0; j0 < n; j0 += kUnroll) {
          float rows[kUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {  // j0 + u < 32: ids past L are -1
            const int32_t id = __shfl_sync(0xffffffffu, mine, j0 + u);
#pragma unroll
            for (int v = 0; v < VEC; ++v) rows[u][v] = 0.0f;
            if (active && id >= 0) {
              load_row<VEC>(table + (long long)id * d + col, rows[u]);
            }
            count += id >= 0;
          }
          // in id order; a padding row adds +0, which leaves the sum's bits
          // as they are (a sum from +0 never holds -0)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] += rows[u][v];
          }
        }
      }
      if (!active) continue;
      if (MEAN) {
        const float c = (float)(count > 1 ? count : 1);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = acc[v] / c;
      }
      store_row<VEC>(out + (long long)bag * d + col, acc);
    }
  }
}

template <int VEC>
void launch(const float* table, const int32_t* ids, float* out, int n_bags,
            int length, int d, int mean, cudaStream_t s) {
  const long long blocks = ((long long)n_bags + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (mean) {
    embedding_bag_kernel<VEC, true><<<grid, kThreads, 0, s>>>(table, ids, out, n_bags,
                                                              length, d);
  } else {
    embedding_bag_kernel<VEC, false><<<grid, kThreads, 0, s>>>(table, ids, out, n_bags,
                                                               length, d);
  }
}

}  // namespace

extern "C" {

// vec: 4, 2 or 1 floats per load (d % vec == 0, table and out aligned to
// 4 * vec bytes); mean: 0 = sum, 1 = mean. Nothing is launched for no bags.
int embedding_bag_launch(const void* table, const void* ids, void* out, int n_bags,
                         int length, int d, int vec, int mean, void* stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const int32_t* i = (const int32_t*)ids;
  float* o = (float*)out;
  if (vec == 4 && d % 4 == 0) {
    launch<4>(t, i, o, n_bags, length, d, mean, s);
  } else if (vec == 2 && d % 2 == 0) {
    launch<2>(t, i, o, n_bags, length, d, mean, s);
  } else if (vec == 1) {
    launch<1>(t, i, o, n_bags, length, d, mean, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
