from repro_torch.kernels.embedding_bag import kernel, ops, ref  # noqa: F401
from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: F401
from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference  # noqa: F401
