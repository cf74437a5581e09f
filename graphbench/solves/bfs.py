"""The ``bfs`` solve: ``repro_torch.core.problems.bfs(root)``. It covers
the directed edges of the root's connected component."""
from repro_torch.core.problems import bfs


def problem(params: dict, root: int):
    return bfs(root)


def edges(graph, root: int) -> int:
    return graph.component_edges(root)
