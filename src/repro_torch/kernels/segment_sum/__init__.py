from repro_torch.kernels.segment_sum import kernel, ops  # noqa: F401
from repro_torch.kernels.segment_sum.ops import (  # noqa: F401
    SegmentLayout,
    segment_layout,
    segment_sum,
    segment_sum_plain,
    take,
    tree_levels,
)
