// Fixed-order segment sum, for Hopper (sm_90a).
//
// No TPU kernel is replaced. The reference's segment sums are
// jax.ops.segment_sum (repro/models/gnn/common.py::aggregate, GCN's
// degrees, the MoE combine in repro/models/layers.py) and the gradients XLA
// takes of jnp.take (DIN's item and category rows, the MoE dispatch) and of
// its edge softmax: deterministic scatter-adds on a TPU. On this card the
// port's index_add_ adds with atomics in an order that changes from run to
// run, so training and inference lost their last bits between runs. This
// kernel is the one sum behind all of them (kernels/segment_sum), and
// behind the embedding bag's backward (kernels/embedding_bag/kernel.py::
// launch_backward: order[p] the bag of the p-th id in id order, one level
// over runs of any length, so its order is (b, i) order):
//
//   out[s] = sum of x[order[p]] for p in [starts[s], starts[s + 1]),
//            in ascending p, from +0.0, in float32
//
// for x (n, d) float32 or bfloat16 (order null: x's own rows p), out (k, d)
// float32 or bfloat16 (rounded once, to nearest even, at the end). The
// layout (kernels/segment_sum/ops.py::segment_layout) is a stable sort of
// the segment ids, so ascending p is ascending row index within a segment,
// and run starts by searchsorted, the bag backward's glue
// (kernels/embedding_bag/kernel.py::backward_runs). A run longer than the
// layout's CHUNK (256) rows is cut into chunks of 256 in ascending order,
// each chunk summed by one launch and the chunk sums summed again by the
// next, so no thread walks more than 256 rows (the bag backward's single
// level excepted); the order is the layout's alone, so two launches give
// the same bits, and the plain version
// (kernels/segment_sum/kernel.py::fold_runs_plain) repeats it bit for bit.
//
// What bounds it: bytes. x is read once (its rows in runs), the order and
// starts once, out written once; one add a element. At DIN's take backward
// (6.6 M ids x 18 into the 10,000,384-row item table) the output alone is
// 720 MB; at GAT's aggregate (E x 64 float32) x dominates.
//
// Design (simple and right; making it fast is later work):
//   * One thread owns one (run, column vector of VEC elements), threads
//     numbered s * (d / VEC) + c, so a warp covers consecutive column
//     vectors of one or a few runs: the run's positions are one broadcast
//     load for the lanes of a run, its row reads VEC-wide and consecutive.
//   * The thread walks its run in order kChunk positions at a time: all
//     kChunk position loads, then all kChunk row loads, then the adds in
//     run order, so a chunk's loads are in flight together and the sum's
//     order is the run's. An empty run writes +0, so no fill kernel runs.
//   * No atomics, no shared memory, no block barrier.
// The wrapper (kernels/segment_sum/kernel.py) checks types, shapes and
// alignment; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
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

// bfloat16 -> float32 is exact: the 16 bits become the high half
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
  } else if constexpr (VEC == 2) {
    const uint32_t t = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(t); v[1] = bf16_hi(t);
  } else {
    const uint32_t t = __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = bf16_lo(t);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TIn, typename TOut, bool ORDERED, int VEC>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const TIn* __restrict__ x, const int64_t* __restrict__ order,
    const int64_t* __restrict__ starts, TOut* __restrict__ out, long long n_runs, int d) {
  const int nv = d / VEC;
  const long long total = n_runs * nv;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long s = t / nv;
    const int col = (int)(t - s * nv) * VEC;
    const long long lo = __ldg(starts + s), hi = __ldg(starts + s + 1);
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (long long p0 = lo; p0 < hi; p0 += kChunk) {
      long long row[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        row[u] = p0 + u < hi ? (ORDERED ? __ldg(order + p0 + u) : p0 + u) : -1;
      }
      float term[kChunk][VEC];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (row[u] >= 0) {
          load_vec<VEC>(x + row[u] * d + col, term[u]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) term[u][v] = 0.0f;
        }
      }
      // in run order; past the run's end nothing is added
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (row[u] >= 0) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += term[u][v];
        }
      }
    }
    TOut* o = out + s * d + col;
#pragma unroll
    for (int v = 0; v < VEC; ++v) store(o + v, acc[v]);
  }
}

template <typename TIn, typename TOut, bool ORDERED>
int launch_vec(const void* x, const void* order, const void* starts, void* out, long long n_runs,
               int d, int vec, cudaStream_t s) {
  const long long total = n_runs * (d / vec);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) blocks = 0x7FFFFFFFLL;  // the kernel strides the rest
  const TIn* xi = (const TIn*)x;
  const int64_t* o = (const int64_t*)order;
  const int64_t* st = (const int64_t*)starts;
  TOut* y = (TOut*)out;
  switch (vec) {
    case 4:
      segment_sum_kernel<TIn, TOut, ORDERED, 4><<<(unsigned)blocks, kThreads, 0, s>>>(
          xi, o, st, y, n_runs, d);
      break;
    case 2:
      segment_sum_kernel<TIn, TOut, ORDERED, 2><<<(unsigned)blocks, kThreads, 0, s>>>(
          xi, o, st, y, n_runs, d);
      break;
    case 1:
      segment_sum_kernel<TIn, TOut, ORDERED, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
          xi, o, st, y, n_runs, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_typed(const void* x, const void* order, const void* starts, void* out,
                 long long n_runs, int d, int vec, cudaStream_t s) {
  return order != nullptr
             ? launch_vec<TIn, TOut, true>(x, order, starts, out, n_runs, d, vec, s)
             : launch_vec<TIn, TOut, false>(x, order, starts, out, n_runs, d, vec, s);
}

}  // namespace

extern "C" {

// x: (n, d) float32 (in_bf16 0) or bfloat16 (1), rows of VEC-aligned width;
// order: (m) int64 rows of x in run order, or null (the positions are x's
// rows); starts: (n_runs + 1) int64 run starts; out: (n_runs, d) float32
// (out_bf16 0) or bfloat16 (1), every element written. vec: 4, 2 or 1
// elements a load (d % vec == 0, x and out aligned to vec elements).
int segment_sum_launch(const void* x, const void* order, const void* starts, void* out,
                       long long n_runs, int d, int in_bf16, int out_bf16, int vec,
                       void* stream) {
  if (n_runs <= 0 || d <= 0) return 0;
  if ((vec != 1 && vec != 2 && vec != 4) || d % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    return out_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(x, order, starts, out, n_runs,
                                                                 d, vec, s)
                    : launch_typed<__nv_bfloat16, float>(x, order, starts, out, n_runs, d, vec,
                                                         s);
  }
  return out_bf16 ? launch_typed<float, __nv_bfloat16>(x, order, starts, out, n_runs, d, vec, s)
                  : launch_typed<float, float>(x, order, starts, out, n_runs, d, vec, s);
}

}  // extern "C"
