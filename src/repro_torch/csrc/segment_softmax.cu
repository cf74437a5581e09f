// Segment softmax over a row-block tile layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/segment_softmax/kernel.py
// ::segment_softmax_pallas (its two pallas_calls at kernel.py:80, the
// stats pass, and kernel.py:92, the normalize pass), under jax.vmap over
// heads as GAT runs it. Scores (H, R, T, Eb) float32 in tile order; dstb
// (R, T, Eb) int32, the row within row block r; valid (R, T, Eb) bool (one
// byte), shared by every head. Out (H, R, T, Eb):
//   w = exp(s - m[row]) / max(l[row], 1e-30) on a valid slot, 0 elsewhere,
// with m, l a row's max and sum of exponentials over its valid slots from
// the identity m = -1e30, l = 0; a row still at the identity is never read
// (no valid slot names it), which is the reference's untouched-row rule.
//
// What bounds it: bytes. The bound counts each slot's score read and its
// weight written once per head, dstb and valid once: 8 H + 5 bytes a slot.
// This design reads the scores twice (a stats sweep, then a normalize
// sweep) and dstb and valid once a sweep per head: 12 H + 10 bytes a slot
// from device memory when the H blocks of a row block, which run side by
// side, find dstb and valid in L2 for all but the first head (106 at H =
// 8 against the bound's 69). What bounds it now (H100 SXM at 700 W, the
// smoke graph's layout at H = 8, 1.79 ms against the 0.65 ms bound): the
// normalize sweep streams its bytes at about 2.6 TB/s (0.83 ms alone); the
// stats sweep (about 1.0 ms) is bound by its arithmetic, an accurate
// exponential a slot and the scan's joins, at about 1.2 TB/s of its bytes.
//
// Design:
//   * One block per (head, row block): blockIdx.x = head, so that the
//     heads of one row block are scheduled together, and blockIdx.y = r.
//     m and l of the block's vb rows (vb <= 8192: 64 KiB) stay in shared
//     memory between the sweeps: the two TPU passes are one launch and m,
//     l never reach device memory.
//   * Stats sweep, a segmented reduction over the slot stream. A run is a
//     maximal stretch of consecutive valid slots of one row; its head is a
//     valid slot whose predecessor is invalid or of another row. Each warp
//     owns one contiguous eighth of the block's slots and walks it kStep =
//     256 slots a step, each thread kSpt = 8 consecutive ones (16-B loads
//     of scores and dstb, 4 B of valid where the layout allows it, the
//     next step's loaded a step ahead), with no block barrier on the way.
//     A thread folds its slots in registers with the online operator (m,
//     l) + (m', l') = (M, l e^(m - M) + l' e^(m' - M)), M = max(m, m'); the
//     warp joins its threads' pieces with a segmented shuffle scan of 5
//     steps and carries the run open at the end of a step into the next.
//     A run that starts and ends inside the warp's range is written to
//     m[row], l[row] by the thread that holds its last slot. Only a run
//     that crosses the edge of a warp's range is staged (the piece that
//     continues into the range and the piece it leaves open), and after
//     one block barrier thread 0 joins the staged pieces in warp order.
//     The order of every float operation is therefore set by the slot
//     order and the block's split into warp ranges alone: a rerun gives
//     the same bits. No float atomics.
//   * What the fast path relies on: each row's valid slots form ONE run in
//     the block, so each row is written once, with a plain store. That
//     holds for every layout the port builds (prepare_tiles keeps the
//     dst-sorted order inside each row block; tests/test_torch_partition.py
//     checks it). The block checks it for itself: it counts the runs it
//     wrote and the rows that hold a sum (l > 0) afterwards. Equal counts
//     mean no row was written twice. If they differ, the block starts the
//     stats sweep again in an ordered mode: warp 0 walks all the slots and
//     folds each run into its row (read, combine, store), one lane after
//     another in slot order, so the weights stay right and stable on any
//     layout, only slower.
//   * Normalize sweep: each thread writes 8 consecutive slots a step (16-B
//     loads and stores), reading m and l of a row from shared memory once
//     per run of its slots; padding slots write 0.
//   * At GAT's Cora shape (H = 8, R = 8 row blocks of 2,048 slots) the grid
//     is 64 blocks, under one wave of 132 SMs, but each warp takes a single
//     step of the stats sweep: the launch is a short chain of dependent
//     loads and block barriers, not a lack of blocks, so a row block is
//     not split over blocks (that would add a cross-block combine of the
//     rows at the split for no fewer bytes).
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
constexpr int kSpt = 8;  // consecutive slots a thread takes a step
constexpr int kStep = 32 * kSpt;  // slots a warp takes a step
constexpr int kChunk = kThreads * kSpt;  // slots a block writes a step
constexpr int kMaxVb = 8192;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;
// how the run that reaches a warp's last slot began
constexpr int kNone = 0;     // the warp's last slot is padding
constexpr int kThrough = 1;  // before the warp: no head in it
constexpr int kFresh = 2;    // at a head inside the warp

// (m, l) <- (m, l) + (m2, l2), the online-softmax operator. Of its two
// rescalings the one by the larger max is exp(0) = 1, so it takes one
// exponential, and selects rather than branches, so that the lanes of a
// warp never run both sides.
__device__ __forceinline__ void join(float& m, float& l, float m2, float l2) {
  const float e = expf(-fabsf(m - m2));
  const bool up = m2 > m;
  l = up ? fmaf(l, e, l2) : fmaf(l2, e, l);
  m = up ? m2 : m;
}

// (m, l) <- (m, l) + (s, 1)
__device__ __forceinline__ void add_slot(float& m, float& l, float s) { join(m, l, s, 1.0f); }

// Load the kSpt slots from i0: scores, rows and validity (false past n).
template <bool kVec>
__device__ __forceinline__ void load_slots(const float* __restrict__ sc,
                                           const int32_t* __restrict__ db,
                                           const uint8_t* __restrict__ va, int i0, int n,
                                           float (&s)[kSpt], int (&row)[kSpt],
                                           bool (&ok)[kSpt]) {
#pragma unroll
  for (int q = 0; q < kSpt / 4; ++q) {
    const int i = i0 + 4 * q;
    if (kVec) {  // n % 4 == 0: a quad is all in or all out
      if (i < n) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + i));
        const int4 r4 = __ldg(reinterpret_cast<const int4*>(db + i));
        const uint32_t v4 = __ldg(reinterpret_cast<const unsigned int*>(va + i));
        s[4 * q] = s4.x; s[4 * q + 1] = s4.y; s[4 * q + 2] = s4.z; s[4 * q + 3] = s4.w;
        row[4 * q] = r4.x; row[4 * q + 1] = r4.y; row[4 * q + 2] = r4.z; row[4 * q + 3] = r4.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) ok[4 * q + k] = ((v4 >> (8 * k)) & 0xFFu) != 0u;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ok[4 * q + k] = false;
          row[4 * q + k] = 0;
          s[4 * q + k] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * q + k;
        ok[j] = i + k < n && va[i + k] != 0;
        row[j] = ok[j] ? __ldg(db + i + k) : 0;
        s[j] = ok[j] ? __ldg(sc + i + k) : 0.0f;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3) segment_softmax_kernel(
    const float* __restrict__ scores,    // (H, R, n_slots)
    const int32_t* __restrict__ dstb,    // (R, n_slots)
    const uint8_t* __restrict__ valid,   // (R, n_slots)
    float* __restrict__ out,             // (H, R, n_slots)
    int r_blocks, int n_slots, int vb) {
  extern __shared__ float smem[];
  float* m_s = smem;      // vb
  float* l_s = m_s + vb;  // vb
  __shared__ float cont_m[kWarps], cont_l[kWarps], tail_m[kWarps], tail_l[kWarps];
  __shared__ int cont_ok[kWarps], tail_row[kWarps], tail_kind[kWarps];
  __shared__ int n_runs, n_rows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int32_t* db = dstb + (size_t)r * n_slots;
  const uint8_t* va = valid + (size_t)r * n_slots;
  const size_t base = ((size_t)h * r_blocks + r) * n_slots;
  const float* sc = scores + base;

  for (int pass = 0; pass < 2; ++pass) {
    const bool ordered = pass == 1;  // the block found a row written twice
    for (int j = tid; j < vb; j += kThreads) {
      m_s[j] = kNeg;
      l_s[j] = 0.0f;
    }
    if (tid == 0) n_runs = n_rows = 0;
    __syncthreads();

    // write a finished run into its row: a store on the fast path, a fold
    // into what the row holds in the ordered mode
    int my_runs = 0;
    auto put = [&](int rr, float m, float l) {
      if (ordered) {
        float om = m_s[rr], ol = l_s[rr];
        join(om, ol, m, l);
        m = om;
        l = ol;
      }
      m_s[rr] = m;
      l_s[rr] = l;
      ++my_runs;
    };

    // this warp's contiguous range of slots, kStep at a time (in the
    // ordered mode warp 0 takes them all, one lane after another)
    const int n_steps = (n_slots + kStep - 1) / kStep;
    const int per = ordered ? n_steps : (n_steps + kWarps - 1) / kWarps;
    const int w_beg = ordered ? (warp == 0 ? 0 : n_slots) : min(n_slots, warp * per * kStep);
    const int w_end = ordered ? n_slots : min(n_slots, w_beg + per * kStep);
    // the run open at the end of the last step, the same in every lane;
    // lead: it began before this warp's range (the warp stages it)
    float c_m = kNeg, c_l = 0.0f;
    bool c_lead = true;
    int c_row = -1;
    if (lane == 0) cont_ok[warp] = 0;
    float nx_s[kSpt];  // the next step's slots, loaded a step ahead
    int nx_row[kSpt];
    bool nx_ok[kSpt];
    load_slots<kVec>(sc, db, va, w_beg + lane * kSpt, w_end, nx_s, nx_row, nx_ok);
    for (int s0 = w_beg; s0 < w_end; s0 += kStep) {
      const int i0 = s0 + lane * kSpt;
      float s[kSpt];
      int row[kSpt];
      bool ok[kSpt];
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        s[j] = nx_s[j];
        row[j] = nx_row[j];
        ok[j] = nx_ok[j];
      }
      load_slots<kVec>(sc, db, va, i0 + kStep, w_end, nx_s, nx_row, nx_ok);

      // the slot before i0 (lane 0: the carried run's, or at the start of the
      // range the previous warp's last), and whether the slot after this
      // thread's last one starts a new run (lane 31: not known, carried)
      int prow = __shfl_up_sync(kFull, row[kSpt - 1], 1);
      bool pok = __shfl_up_sync(kFull, (int)ok[kSpt - 1], 1) != 0;
      if (lane == 0) {
        if (s0 == w_beg) {
          pok = i0 > 0 && va[i0 - 1] != 0;
          prow = pok ? __ldg(db + i0 - 1) : 0;
        } else {
          pok = c_row >= 0;
          prow = c_row;
        }
      }
      bool head[kSpt];
      head[0] = ok[0] && !(pok && prow == row[0]);
#pragma unroll
      for (int j = 1; j < kSpt; ++j) head[j] = ok[j] && !(ok[j - 1] && row[j - 1] == row[j]);
      const bool next_breaks = __shfl_down_sync(kFull, (int)(head[0] || !ok[0]), 1) != 0;

      // fold the thread's slots in registers; a run that ends here and began
      // at a head in this thread is a finished record at its last slot
      const bool cont_open = ok[0] && !head[0];
      float rec_m[kSpt], rec_l[kSpt];
      bool rec_on[kSpt];
      float cm = kNeg, cl = 0.0f;  // the run being folded
      bool from_head = false;
      float pm = kNeg, pl = 0.0f;  // the piece continuing from lane - 1
      int p_end = -1;              // its last slot, if it ends in this thread
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        if (head[j]) {
          cm = kNeg;
          cl = 0.0f;
          from_head = true;
        }
        if (ok[j]) add_slot(cm, cl, s[j]);
        const bool ends = ok[j] && (j + 1 < kSpt ? (head[j + 1] || !ok[j + 1])
                                                 : (lane < 31 && next_breaks));
        rec_on[j] = ends && from_head;
        rec_m[j] = cm;
        rec_l[j] = cl;
        if (ends && !from_head) {
          pm = cm;
          pl = cl;
          p_end = j;
        }
      }
      // segmented inclusive scan of the run that reaches each thread's last
      // slot; f: that run began at a head inside this step
      const bool last_ok = ok[kSpt - 1];
      float xm = last_ok ? cm : kNeg, xl = last_ok ? cl : 0.0f;
      bool xf = last_ok ? from_head : true;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float ym = __shfl_up_sync(kFull, xm, d);
        const float yl = __shfl_up_sync(kFull, xl, d);
        const bool yf = __shfl_up_sync(kFull, (int)xf, d) != 0;
        if (lane >= d && !xf) {
          float am = ym, al = yl;
          join(am, al, xm, xl);
          xm = am;
          xl = al;
          xf = yf;
        }
      }
      // a run with no head in this step continues the carried one
      bool x_lead = false;
      if (!xf) {
        float am = c_m, al = c_l;
        join(am, al, xm, xl);
        xm = am;
        xl = al;
        x_lead = c_lead;
      }
      float cin_m = __shfl_up_sync(kFull, xm, 1);
      float cin_l = __shfl_up_sync(kFull, xl, 1);
      bool cin_lead = __shfl_up_sync(kFull, (int)x_lead, 1) != 0;
      bool put_carry = false;  // lane 0: the carried run ended at the step's edge
      if (lane == 0) {
        cin_m = c_m;
        cin_l = c_l;
        cin_lead = c_lead;
        if (s0 == w_beg) cont_ok[warp] = cont_open;  // the range opens inside a run
        if (c_row >= 0 && !cont_open) {
          if (c_lead) {  // the run the range opened in ends here: staged
            cont_m[warp] = c_m;
            cont_l[warp] = c_l;
          } else {
            put_carry = true;
          }
        }
      }
      if (cont_open && p_end >= 0) {  // the continuing run ends in this thread
        join(cin_m, cin_l, pm, pl);
        if (!cin_lead) {  // it began in this warp's range: finished
#pragma unroll
          for (int j = 0; j < kSpt; ++j) {
            if (j == p_end) {
              rec_on[j] = true;
              rec_m[j] = cin_m;
              rec_l[j] = cin_l;
            }
          }
        } else {  // it began before the range: staged
          cont_m[warp] = cin_m;
          cont_l[warp] = cin_l;
        }
      }
      // carry the run open at lane 31's last slot into the next step
      const int c_row_was = c_row;
      const float c_m_was = c_m, c_l_was = c_l;
      c_m = __shfl_sync(kFull, xm, 31);
      c_l = __shfl_sync(kFull, xl, 31);
      c_lead = __shfl_sync(kFull, (int)x_lead, 31) != 0;
      c_row = __shfl_sync(kFull, last_ok ? row[kSpt - 1] : -1, 31);
      if (c_row < 0) {
        c_m = kNeg;
        c_l = 0.0f;
        c_lead = false;
      }

      auto put_mine = [&]() {
        if (put_carry) put(c_row_was, c_m_was, c_l_was);
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          if (rec_on[j]) put(row[j], rec_m[j], rec_l[j]);
        }
      };
      if (!ordered) {
        put_mine();
      } else {  // one lane after another, in slot order
        for (int k = 0; k < 32; ++k) {
          if (lane == k) put_mine();
          __syncwarp();
        }
      }
    }
    if (lane == 0) {  // the run left open at the end of the range
      tail_kind[warp] = c_row < 0 ? kNone : (c_lead ? kThrough : kFresh);
      tail_row[warp] = c_row;
      tail_m[warp] = c_m;
      tail_l[warp] = c_l;
    }
    __syncthreads();
    if (tid == 0) {  // join the pieces that cross warps, in warp order
      int o_row = -1;
      float o_m = kNeg, o_l = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        const int kind = tail_kind[w];
        if (kind == kThrough) {
          join(o_m, o_l, tail_m[w], tail_l[w]);
          continue;
        }
        if (cont_ok[w]) join(o_m, o_l, cont_m[w], cont_l[w]);
        if (o_row >= 0) put(o_row, o_m, o_l);
        o_row = -1;
        o_m = kNeg;
        o_l = 0.0f;
        if (kind == kFresh) {
          o_row = tail_row[w];
          o_m = tail_m[w];
          o_l = tail_l[w];
        }
      }
      if (o_row >= 0) put(o_row, o_m, o_l);
    }
    __syncthreads();

    // every run wrote one row; a row written twice shows as fewer rows
    int my_rows = 0;
    for (int j = tid; j < vb; j += kThreads) my_rows += l_s[j] > 0.0f;
    atomicAdd(&n_runs, my_runs);
    atomicAdd(&n_rows, my_rows);
    __syncthreads();
    const bool done = ordered || n_runs == n_rows;
    __syncthreads();
    if (done) break;
  }

  // normalize sweep
  float* o = out + base;
  for (int c0 = 0; c0 < n_slots; c0 += kChunk) {
    const int i0 = c0 + tid * kSpt;
    if (i0 >= n_slots) continue;
    float s[kSpt];
    int row[kSpt];
    bool ok[kSpt];
    load_slots<kVec>(sc, db, va, i0, n_slots, s, row, ok);
    float w[kSpt];
    int crow = -1;
    float cm = 0.0f, cl = 1.0f;
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      w[j] = 0.0f;
      if (ok[j]) {
        if (row[j] != crow) {
          crow = row[j];
          cm = m_s[crow];
          cl = fmaxf(l_s[crow], 1e-30f);
        }
        w[j] = expf(s[j] - cm) / cl;
      }
    }
#pragma unroll
    for (int q = 0; q < kSpt / 4; ++q) {
      const int i = i0 + 4 * q;
      if (kVec) {
        if (i < n_slots) {
          *reinterpret_cast<float4*>(o + i) =
              make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (i + k < n_slots) o[i + k] = w[4 * q + k];
        }
      }
    }
  }
}

size_t smem_bytes(int vb) { return sizeof(float) * 2 * (size_t)vb; }

template <bool kVec>
int launch(const void* scores, const void* dstb, const void* valid, void* out, int heads,
           int r_blocks, int n_slots, int vb, cudaStream_t stream) {
  const size_t smem = smem_bytes(vb);
  cudaError_t err = cudaFuncSetAttribute(segment_softmax_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  segment_softmax_kernel<kVec><<<dim3(heads, r_blocks), kThreads, smem, stream>>>(
      (const float*)scores, (const int32_t*)dstb, (const uint8_t*)valid, (float*)out,
      r_blocks, n_slots, vb);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

extern "C" {

int segment_softmax_launch(const void* scores, const void* dstb, const void* valid,
                           void* out, int heads, int r_blocks, int n_slots, int vb,
                           void* stream) {
  if (heads == 0 || r_blocks == 0 || n_slots == 0) return 0;
  if (vb < 1 || vb > kMaxVb || r_blocks > 65535) return (int)cudaErrorInvalidValue;
  // 16-B loads and stores where every row of the layout starts on 16 B
  const bool vec = n_slots % 4 == 0 && aligned(scores, 16) && aligned(dstb, 16) &&
                   aligned(out, 16) && aligned(valid, 4);
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(scores, dstb, valid, out, heads, r_blocks, n_slots, vb, s)
             : launch<false>(scores, dstb, valid, out, heads, r_blocks, n_slots, vb, s);
}

}  // extern "C"
