// Segment softmax over a row-block tile layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/segment_softmax/kernel.py
// ::segment_softmax_pallas (its two pallas_calls at kernel.py:80, the
// stats pass, and kernel.py:92, the normalize pass), under jax.vmap over
// heads as GAT runs it. Scores (H, R, T, Eb) float32 in tile order; dstb
// (R, T, Eb) int32, the row within row block r; valid (R, T, Eb) bool (one
// byte), shared by every head. Out (H, R, T, Eb):
//   w = exp(s - m[row]) / max(l[row], 1e-30) on a valid slot, 0 elsewhere,
// with m, l a row's running max and sum of exponentials over its valid
// slots from the identity m = -1e30, l = 0; a row still at the identity is
// rescaled by 0, never by exp(-1e30 - m), which is the reference's
// untouched-row rule.
//
// What bounds it: bytes. Each slot's score is read twice and its weight
// written once, per head; dstb and valid are read twice per head (the H
// blocks of a row block run side by side, so the later heads find them in
// L2). Two exponentials a valid slot, about 1 per 10 B moved: far under
// the card's float32 rate.
//
// Design:
//   * One block per (head, row block): blockIdx.x = head, so that the
//     heads of one row block are scheduled together, and blockIdx.y = r.
//     The block sweeps its T * Eb slots twice, kThreads slots a step, with
//     coalesced loads; m and l for its vb rows (vb <= 8192: 64 KiB) stay in
//     shared memory between the sweeps, so the two TPU passes are one
//     launch and m, l never reach device memory.
//   * Sweep 1 (stats), deterministic: within a warp, the slots of one row
//     are grouped with __match_any_sync; the group's leader takes the
//     group max gm and the sum of exp(s - gm) over the group in lane order.
//     The leaders' (row, gm, gs) are staged in shared memory, and warp 0
//     folds them into (m, l) warp by warp (the leaders of one warp own
//     distinct rows): m' = max(m, gm), l' = l * exp(m - m') + gs * exp(gm -
//     m'). The order of every float operation is fixed by the slot order,
//     so a rerun gives the same bits. No float atomics.
//   * Sweep 2 (normalize): each slot reads m and l of its row from shared
//     memory and writes its weight; padding slots write 0.
//   * The layout has no tile counts, so padding tiles are read too; a row
//     block's T is set by the fattest block (see PERF.md).
// The wrapper (kernel.py) checks shapes and types before it calls the
// launcher; the launcher returns a CUDA error code (cudaErrorInvalidValue
// when vb rows do not fit one block or R exceeds the grid's y extent).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVb = 8192;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads) segment_softmax_kernel(
    const float* __restrict__ scores,    // (H, R, n_slots)
    const int32_t* __restrict__ dstb,    // (R, n_slots)
    const uint8_t* __restrict__ valid,   // (R, n_slots)
    float* __restrict__ out,             // (H, R, n_slots)
    int r_blocks, int n_slots, int vb) {
  extern __shared__ float smem[];
  float* m = smem;                 // vb
  float* l = m + vb;               // vb
  float* st_x = l + vb;            // kThreads: each thread's score
  float* st_m = st_x + kThreads;   // kThreads: leader's group max
  float* st_l = st_m + kThreads;   // kThreads: leader's group sum
  int* st_row = reinterpret_cast<int*>(st_l + kThreads);  // kThreads

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const size_t edge_base = (size_t)r * n_slots;
  const size_t base = ((size_t)h * r_blocks + r) * n_slots;

  for (int j = tid; j < vb; j += kThreads) {
    m[j] = kNeg;
    l[j] = 0.0f;
  }
  __syncthreads();

  // sweep 1: each row's max and sum of exponentials, online
  for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
    const int s = s0 + tid;
    bool ok = false;
    int row = 0;
    float x = 0.0f;
    if (s < n_slots && valid[edge_base + s]) {
      ok = true;
      row = __ldg(dstb + edge_base + s);
      x = __ldg(scores + base + s);
    }
    st_x[tid] = x;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? row : -1 - lane);
    __syncwarp();
    const bool leader = ok && lane == __ffs(peers) - 1;
    float gm = kNeg, gs = 0.0f;
    if (leader) {
      for (unsigned p = peers; p != 0; p &= p - 1) {
        gm = fmaxf(gm, st_x[(warp << 5) + __ffs(p) - 1]);
      }
      for (unsigned p = peers; p != 0; p &= p - 1) {
        gs += expf(st_x[(warp << 5) + __ffs(p) - 1] - gm);
      }
    }
    st_row[tid] = leader ? row : -1;
    st_m[tid] = gm;
    st_l[tid] = gs;
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < kWarps; ++w) {
        const int i = (w << 5) + lane;
        const int rr = st_row[i];
        if (rr >= 0) {
          const float m_old = m[rr];
          const float g_max = st_m[i];
          const float m_new = fmaxf(m_old, g_max);
          const float scale = m_old <= kNeg / 2 ? 0.0f : expf(m_old - m_new);
          l[rr] = l[rr] * scale + st_l[i] * expf(g_max - m_new);
          m[rr] = m_new;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // sweep 2: normalize
  for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
    const int s = s0 + tid;
    if (s >= n_slots) break;
    float w = 0.0f;
    if (valid[edge_base + s]) {
      const int row = __ldg(dstb + edge_base + s);
      w = expf(__ldg(scores + base + s) - m[row]) / fmaxf(l[row], 1e-30f);
    }
    out[base + s] = w;
  }
}

size_t smem_bytes(int vb) {
  return sizeof(float) * (2 * (size_t)vb + 4 * kThreads);
}

}  // namespace

extern "C" {

int segment_softmax_launch(const void* scores, const void* dstb, const void* valid,
                           void* out, int heads, int r_blocks, int n_slots, int vb,
                           void* stream) {
  if (heads == 0 || r_blocks == 0 || n_slots == 0) return 0;
  if (vb < 1 || vb > kMaxVb || r_blocks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(vb);
  cudaError_t err = cudaFuncSetAttribute(
      segment_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  segment_softmax_kernel<<<dim3(heads, r_blocks), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int32_t*)dstb, (const uint8_t*)valid, (float*)out,
      r_blocks, n_slots, vb);
  return (int)cudaGetLastError();
}

}  // extern "C"
