"""Design variants of the graph kernels that ``tools/kernel_arm_times.py
--variant NAME`` times against the kernels as they are: each is a list of
text edits (source file under ``src/repro_torch/csrc/``, old text, new
text) applied to a copy of the sources. A variant answers one design
question on the card; its outputs need not be right (``no_atomics``)."""

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

VARIANTS = {
    # the one-lane scatter testing its candidate tiles one a warp iteration
    # (a dependent load each), not 32 at once with one ballot
    "scatter_scan_per_tile": [("scatter_reduce_cores.cu", _ONE_LANE_BALLOT, _ONE_LANE_PER_TILE)],
    # the scatter with every load as it is but no atomic sent: what the
    # atomics cost (the outputs keep the identity)
    "scatter_no_atomics": [("scatter_reduce_cores.cu", _LOWER,
                            _LOWER + "  if (x == 0x12345u && c == 0x54321u) atomicOr(cell, x);\n"
                                     "  return;\n")],
}
