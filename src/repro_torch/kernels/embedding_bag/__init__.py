from repro_torch.kernels.embedding_bag import kernel, ops, ref  # noqa: F401
from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: F401
from repro_torch.kernels.embedding_bag.ref import (  # noqa: F401
    embedding_bag_backward_reference, embedding_bag_reference,
)
