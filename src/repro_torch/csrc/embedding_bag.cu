// Embedding bag (per bag, the sum or mean of table rows picked by id), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py
// ::embedding_bag_pallas (its pallas_call at kernel.py:88): table (N, D)
// float32 x ids (B, L) int32 -> out (B, D) float32. An id < 0 is padding;
// mean divides a bag's sum by max(count of real ids, 1).
//
// What bounds it: bytes. Each real id moves one row of D x 4 B (72 B at the
// published DIN width D = 18, touching three 32-B sectors); the ids are read
// once and the output written once. One add per real id and column. Where
// the table sits in L2 (DIN's 10,000-row category table, 720 KB), the row
// sectors come out of L2 and the load instructions, not HBM, set the pace.
// What bounds it now (H100 SXM at 700 W, tools/bag_times.py, sum): DIN's
// B = 512 and B = 1 bags take 0.0036 and 0.0034 ms, a launch and two
// dependent loads (the ids, then the rows); B = 262,144 takes 0.082 ms, 5.2x
// its HBM bound, moving ~564 MB of row sectors out of L2 (~6.9 TB/s); cold
// 100-id bags over the 10,000,384-row item table 0.019 ms, 2.9x.
//
// Design:
//   * A lane owns one (bag, column vector) pair: VEC floats of one column
//     block of its bag (a row starts at id * D * 4 B, so float4 needs
//     D % 4 == 0 and float2 D % 2 == 0, with the table aligned to match; the
//     wrapper picks VEC). A bag takes nv = D / VEC lanes (at most 32), and a
//     warp holds 32 / nv bags side by side: at D = 18 (float2) 3 bags on 27
//     lanes, so one warp load instruction fetches 3 rows. D wider than
//     32 * VEC gives a bag the whole warp and walks its column chunks.
//   * Each lane reads its bag's ids itself (16-B loads where L % 4 == 0 and
//     the ids are 16-B aligned; the lanes of one bag read the same words)
//     and issues the row loads of kChunk ids before the first add, so all 32
//     rows of a DIN bag are in flight in one latency round; a padding id
//     loads nothing and adds +0. Where the bags fill every SM four times
//     over (serving's bulk batches), kChunk is halved: the registers it
//     frees hold more warps an SM, which the L2-bound bulk shape rewards
//     (H100 SXM, tools/bag_times.py --variant bag_chunk_half: B = 262,144
//     0.127 -> 0.083 ms) and the latency-bound small ones do not.
//   * Each column is summed in registers in id order from +0, the TPU
//     kernel's and the plain version's order, so every shape gives the same
//     bits as both (a sum from +0 never holds -0, so the +0 of a padding id
//     leaves it as it is). The count of real ids for mean is kept in the
//     same walk; mean divides, as the plain version does.
//   * Blocks hold 1 to 8 warps, as many as spread the bags over every SM:
//     a small batch (retrieval's B = 1, serving's 512) runs on as many SMs
//     as it has warps.
//   * Row offsets are 64-bit: the DIN item table has 10,000,384 rows.
// Ids must be < N; the wrapper cannot check that without reading them back.
// The wrapper (kernels/embedding_bag/kernel.py) checks shapes and types; the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSMs = 132;
// from this many warps on (4 waves of 8-warp blocks), half the row loads in
// flight a lane
constexpr long long kFullWarps = 4LL * kSMs * (kMaxThreads / 32);

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

// Row loads a lane keeps in flight: a DIN bag's 32 ids at once (VEC 4: 16),
// or half that where the bags fill every SM many times over (FULL false),
// which frees registers for more warps an SM.
template <int VEC, bool FULL>
__host__ __device__ constexpr int chunk() {
  return (VEC == 4 ? 16 : 32) / (FULL ? 1 : 2);
}

template <int VEC, bool MEAN, bool FULL>
__global__ void __launch_bounds__(kMaxThreads) embedding_bag_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ ids,
    float* __restrict__ out, int n_bags, int length, int d, int vec_ids) {
  constexpr int kChunk = chunk<VEC, FULL>();
  const int nv = d / VEC;                    // column vectors a row
  const int lpb = nv < 32 ? nv : 32;         // lanes a bag
  const int bpw = 32 / lpb;                  // bags a warp
  const int lane = threadIdx.x & 31;
  const int g = lane / lpb;
  const long long warp = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long bag = warp * bpw + g;
  if (g >= bpw || bag >= n_bags) return;  // no barrier or shuffle below
  const int32_t* bag_ids = ids + bag * length;
  float* bag_out = out + bag * d;

  for (int cv = lane % lpb; cv < nv; cv += lpb) {
    const float* col = table + cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int count = 0;
    for (int j0 = 0; j0 < length; j0 += kChunk) {
      int32_t id[kChunk];
      if (vec_ids) {  // length % 4 == 0: a 4-id group is all in or all out
#pragma unroll
        for (int q = 0; q < kChunk; q += 4) {
          int4 t = make_int4(-1, -1, -1, -1);
          if (j0 + q < length) t = __ldg(reinterpret_cast<const int4*>(bag_ids + j0 + q));
          id[q] = t.x; id[q + 1] = t.y; id[q + 2] = t.z; id[q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          id[u] = j0 + u < length ? __ldg(bag_ids + j0 + u) : -1;
        }
      }
      float rows[kChunk][VEC];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) rows[u][v] = 0.0f;
        if (id[u] >= 0) load_row<VEC>(col + (long long)id[u] * d, rows[u]);
        count += id[u] >= 0;
      }
      // in id order; a padding row adds +0
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += rows[u][v];
      }
    }
    if (MEAN) {
      const float c = (float)(count > 1 ? count : 1);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = acc[v] / c;
    }
    store_row<VEC>(bag_out + cv * VEC, acc);
  }
}

template <int VEC>
cudaError_t launch(const float* table, const int32_t* ids, float* out, int n_bags,
                   int length, int d, int mean, int vec_ids, cudaStream_t s) {
  const int nv = d / VEC;
  const int bpw = nv < 32 ? 32 / nv : 1;
  const long long warps = ((long long)n_bags + bpw - 1) / bpw;
  // as many warps a block as spread the warps over every SM, 1 to 8
  long long wpb = (warps + kSMs - 1) / kSMs;
  wpb = wpb < 1 ? 1 : (wpb > kMaxThreads / 32 ? kMaxThreads / 32 : wpb);
  const long long blocks = (warps + wpb - 1) / wpb;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const int threads = (int)wpb * 32;
  const bool full = warps < kFullWarps;
  auto kernel = mean ? (full ? embedding_bag_kernel<VEC, true, true>
                             : embedding_bag_kernel<VEC, true, false>)
                     : (full ? embedding_bag_kernel<VEC, false, true>
                             : embedding_bag_kernel<VEC, false, false>);
  kernel<<<(unsigned)blocks, threads, 0, s>>>(table, ids, out, n_bags, length, d, vec_ids);
  return cudaGetLastError();
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
  const int vec_ids = length % 4 == 0 && (uintptr_t)ids % 16 == 0;
  if (vec == 4 && d % 4 == 0) return (int)launch<4>(t, i, o, n_bags, length, d, mean, vec_ids, s);
  if (vec == 2 && d % 2 == 0) return (int)launch<2>(t, i, o, n_bags, length, d, mean, vec_ids, s);
  if (vec == 1) return (int)launch<1>(t, i, o, n_bags, length, d, mean, vec_ids, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
