from repro_torch.kernels.csr_gather_reduce.kernel import (  # noqa: F401
    gather_reduce_cores,
    gather_reduce_cores_plain,
)
from repro_torch.kernels.csr_gather_reduce.ops import (  # noqa: F401
    TileLayout,
    choose_src_bits,
    combine_split_rows,
    pack_edge_words,
    prepare_tiles,
    split_map_from_row_orig,
    stack_packed_tiles,
)
from repro_torch.kernels.csr_gather_reduce.scatter import (  # noqa: F401
    scatter_reduce_cores,
    scatter_reduce_cores_plain,
)
