"""The ``sssp`` solve: ``repro_torch.core.problems.sssp(root)`` over the
configuration's float32 weights. It covers the directed edges of the root's
connected component."""
from repro_torch.core.problems import sssp


def problem(params: dict, root: int):
    return sssp(root)


def edges(graph, root: int) -> int:
    return graph.component_edges(root)
