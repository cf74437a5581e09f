// Embedding bag backward (the table's gradient of a per-bag sum or mean), for
// Hopper (sm_90a).
//
// No TPU kernel is replaced: the reference differentiates its XLA bag
// (repro/models/recsys/din.py through embedding_bag_reference), and its
// Pallas bag (repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas)
// is forward only. This is the backward of the port's forward kernel
// (csrc/embedding_bag.cu): grad_out (B, D) float32 x ids (B, L) int32 ->
// grad (N, D) float32, where
//
//   grad[n] = sum over every (b, i) with ids[b, i] == n, in (b, i)
//             row-major order, starting from +0.0, of
//             grad_out[b]                    (sum)
//             grad_out[b] / max(count_b, 1)  (mean; the division first, as
//                                             the forward divides)
//
// An id < 0 is padding and adds nothing; a row no id touches is 0. The
// order is fixed, so the gradient is the same bits on every run and the
// same bits as the plain version on the CPU
// (kernels/embedding_bag/ref.py::embedding_bag_backward_reference), where
// the card's index_add_ adds with atomics in an order that changes from run
// to run.
//
// What bounds it: bytes. grad_out is read (each bag's row once per id that
// names it, from L2 where it fits), the ids are read once by the sort, the
// gradient written once; the sort's keys and positions are written and read
// back once. At DIN's train_batch (B = 65,536, L = 32, the 10,000 x 18
// category table) that is 4.72 MB + 8.39 MB + 0.72 MB before the sort.
//
// Design (a simple one that is right; hub rows are correct but serial):
//   * Glue in the wrapper (kernels/embedding_bag/kernel.py): a stable
//     torch.sort of the flattened ids (B * L), so each row's occurrences lie
//     together in (b, i) order, and torch.searchsorted of 0..N into the
//     sorted ids, so row n's run is [start[n], start[n + 1]); padding sorts
//     first and lies in no run. For mean, the count of real ids a bag.
//   * One thread owns one (row, column) of the gradient, threads numbered
//     n * D + d so a warp covers consecutive columns of one or two rows:
//     the run's positions are the same address for the lanes of a row
//     (one broadcast load) and its grad_out reads are consecutive floats.
//   * The thread walks its row's run in order, kChunk positions at a time:
//     all kChunk position loads, then all kChunk grad_out loads, then the
//     adds in run order, so the loads of a chunk are in flight together and
//     the sum's order is the run's. An empty run writes +0, so no fill
//     kernel runs before it.
// The wrapper checks shapes, types and that B * L < 2^31; the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;

template <bool MEAN>
__global__ void __launch_bounds__(kThreads) embedding_bag_backward_kernel(
    const float* __restrict__ grad_out, const int64_t* __restrict__ order,
    const int64_t* __restrict__ start, const int32_t* __restrict__ counts,
    float* __restrict__ grad, long long n_rows, int length, int d) {
  const long long total = n_rows * d;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long n = t / d;
    const int col = (int)(t - n * d);
    const long long lo = __ldg(start + n), hi = __ldg(start + n + 1);
    float acc = 0.0f;
    for (long long p0 = lo; p0 < hi; p0 += kChunk) {
      int bag[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        bag[u] = p0 + u < hi ? (int)__ldg(order + p0 + u) / length : -1;  // B * L < 2^31
      }
      float term[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        term[u] = 0.0f;
        if (bag[u] >= 0) {
          term[u] = __ldg(grad_out + (long long)bag[u] * d + col);
          if (MEAN) {
            const int c = __ldg(counts + bag[u]);
            term[u] = term[u] / (float)(c > 1 ? c : 1);
          }
        }
      }
      // in run order, i.e. (b, i) order; past the run's end nothing is added
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (bag[u] >= 0) acc += term[u];
      }
    }
    grad[t] = acc;
  }
}

}  // namespace

extern "C" {

// order: (B * L) int64 positions b * L + i of the ids, stably sorted by id;
// start: (N + 1) int64 run starts of rows 0..N in that order; counts: (B)
// int32 real ids a bag (mean only, else may be null); grad: (N, D) float32,
// every element written. mean: 0 = sum, 1 = mean.
int embedding_bag_backward_launch(const void* grad_out, const void* order, const void* start,
                                  const void* counts, void* grad, long long n_rows, int length,
                                  int d, int mean, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  if (length <= 0) length = 1;  // no ids: every run is empty
  if (mean && counts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = n_rows * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) blocks = 0x7FFFFFFFLL;  // the kernel strides the rest
  const float* g = (const float*)grad_out;
  const int64_t* o = (const int64_t*)order;
  const int64_t* st = (const int64_t*)start;
  const int32_t* c = (const int32_t*)counts;
  float* out = (float*)grad;
  if (mean) {
    embedding_bag_backward_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, o, st, c, out, n_rows, length, d);
  } else {
    embedding_bag_backward_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, o, st, c, out, n_rows, length, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
