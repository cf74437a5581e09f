from repro_torch.kernels.segment_softmax import kernel, ops, ref  # noqa: F401
from repro_torch.kernels.segment_softmax.ops import (  # noqa: F401
    segment_softmax,
    segment_softmax_tiled,
)
from repro_torch.kernels.segment_softmax.ref import segment_softmax_reference  # noqa: F401
