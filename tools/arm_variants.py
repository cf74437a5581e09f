"""Design variants of the kernels that ``tools/kernel_arm_times.py
--variant NAME`` (``tools/bag_times.py --variant NAME`` for the bag) times
against the kernels as they are: each is a list of text edits (source file
under ``src/repro_torch/csrc/``, old text, new text) applied to a copy of
the sources. A variant answers one design question on the card; its
outputs need not be right (``no_atomics``)."""

_ONE_LANE_BALLOT = """  for (int first = warp; first < n_tiles; first += 32 * n_warps) {
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
"""
_ONE_LANE_PER_TILE = """  for (int first = warp; first < n_tiles; first += n_warps) {
    const int cb = first / t_tiles;  // one candidate at a time, the same for every lane
    const bool runs = fetch != nullptr ? __ldg(fetch + first) == first - cb * t_tiles
                                       : first - cb * t_tiles < __ldg(counts + cb);
    for (unsigned todo = runs ? 1u : 0u; todo != 0u; todo = 0u) {
      const int tile = first;
      uint32_t* out_c = out + (long long)(tile / (t_tiles * b_blocks)) * num_rows;
"""
_LOWER = ("__device__ __forceinline__ void lower_cell(uint32_t* cell, uint32_t x, uint32_t c, "
          "int is_or,\n                                           int is_f32) {\n")

_BUCKET_SHAPE = "constexpr int kThreads = 512;\nconstexpr int kSlots = 4;"
_BUCKET_START = "  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n"


def _bucket_shape(threads, slots):
    """The one-bucket kernel with another block size and slots a lane."""
    return [("gather_reduce.cu", _BUCKET_SHAPE,
             f"constexpr int kThreads = {threads};\nconstexpr int kSlots = {slots};")]


VARIANTS = {
    # the one-bucket kernel's block size and slots a lane (the kernel: 512
    # threads, 4 slots a lane) at the smoke's ~2,000 slots a row block
    "bucket_t256_s4": _bucket_shape(256, 4),
    "bucket_t128_s16": _bucket_shape(128, 16),
    # the one-bucket kernel with no slot walked: the floor a launch pays for
    # the accumulator's set-up, barriers and write-out (wrong outputs)
    "bucket_empty_walk": [("gather_reduce.cu", "s - kS * lane < s_end; s += kStep",
                           "s - kS * lane < 0; s += kStep")],
    # the one-bucket kernel returning at once: the launch alone (wrong outputs)
    "bucket_return_at_once": [("gather_reduce.cu", _BUCKET_START,
                               "  if (n_slots >= 0) return;\n" + _BUCKET_START)],
    # the one-bucket kernel loading src and dstb beside the valid bytes, not
    # after them (one memory latency fewer, padding slots' words read too)
    "bucket_no_valid_wait": [("gather_reduce.cu", "if (vw[q] == 0u) continue;",
                              "if (s >= s_end) continue;")],
    # the embedding bag with half the row loads in flight a lane at every B
    # (the kernel halves them only where the bags fill the card 4 times over)
    "bag_chunk_half": [("embedding_bag.cu", "const bool full = warps < kFullWarps;",
                        "const bool full = false;")],
    # the embedding bag with every row load of a DIN bag in flight at every B
    "bag_chunk_full": [("embedding_bag.cu", "const bool full = warps < kFullWarps;",
                        "const bool full = true;")],
    # the embedding bag held to 3 blocks of 256 an SM (at most 85 registers)
    "bag_3_blocks": [("embedding_bag.cu",
                      "__global__ void __launch_bounds__(kMaxThreads) embedding_bag_kernel(",
                      "__global__ void __launch_bounds__(kMaxThreads, 3) embedding_bag_kernel(")],
    # the one-lane scatter testing its candidate tiles one a warp iteration
    # (a dependent load each), not 32 at once with one ballot
    "scatter_scan_per_tile": [("scatter_reduce_cores.cu", _ONE_LANE_BALLOT, _ONE_LANE_PER_TILE)],
    # the scatter with every load as it is but no atomic sent: what the
    # atomics cost (the outputs keep the identity)
    "scatter_no_atomics": [("scatter_reduce_cores.cu", _LOWER,
                            _LOWER + "  if (x == 0x12345u && c == 0x54321u) atomicOr(cell, x);\n"
                                     "  return;\n")],
}
