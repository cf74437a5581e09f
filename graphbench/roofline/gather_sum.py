"""The work of one PageRank iteration of the pull gather kernel's sum arm
(``gather_reduce_cores``, ``sum_f32``), counted from the graph and the
problem, not from the layout, so that a change of layout cannot move it:

- 4 B for each directed edge (one 32-bit word naming source and
  destination, as the compressed stream does);
- 4 B for each source value gathered, each vertex's once;
- 4 B for each label written, each vertex's once.

Operations (one add an edge) are far below the bytes' time on an H100, so
the bound is bytes at the HBM peak.
"""
from graphbench.roofline import peaks


def bytes_per_iteration(num_vertices: int, num_edges: int) -> int:
    return 4 * num_edges + 4 * num_vertices + 4 * num_vertices


def flops_per_iteration(num_vertices: int, num_edges: int) -> int:
    return num_edges


def bound_seconds(num_vertices: int, num_edges: int, iterations: int) -> tuple[float, str]:
    """Least time for ``iterations`` iterations and what bounds it."""
    by_bytes = bytes_per_iteration(num_vertices, num_edges) * iterations / peaks.HBM_BYTES_PER_S
    by_ops = flops_per_iteration(num_vertices, num_edges) * iterations / peaks.F32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
