"""The ``pagerank`` solve: ``repro_torch.core.problems.pagerank`` with
``params["damping"]`` and ``params["tol"]``, capped at
``params["iterations"]`` (the engine's ``max_iters``; tol 0 runs every
iteration). It covers every directed edge."""
from repro_torch.core.problems import pagerank


def problem(params: dict, root):
    return pagerank(damping=float(params["damping"]), tol=float(params["tol"]))


def engine_options(params: dict) -> dict:
    return {"max_iters": int(params["iterations"])}


def edges(graph, root) -> int:
    return graph.num_edges
