"""The benchmark's generators and plain references, on the CPU at small
scales: BFS and SSSP against a textbook queue BFS and Dijkstra written
here, PageRank against a loop over the vertices, and the generators'
determinism and kernel-1 properties."""
import heapq
import json
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from graphbench.run import load_module  # noqa: E402

CONFIGS = ("graph500-kron-s20", "gap-urand-s20")


def _config(name, scale, **kw):
    cfg = json.loads((ROOT / "graphbench" / "configs" / f"{name}.json").read_text())
    return dict(cfg, scale=scale, **kw)


def _generate(name, scale, seed, **kw):
    cfg = _config(name, scale, **kw)
    return load_module(ROOT, "generators", cfg["generator"]).generate(cfg, seed, "cpu")


def _ref(kind):
    return load_module(ROOT, "reference", kind)


def _adjacency(g):
    adj = [[] for _ in range(g["num_vertices"])]
    w = g["weights"].tolist() if g["weights"] is not None else [1.0] * g["src"].numel()
    for s, d, x in zip(g["src"].tolist(), g["dst"].tolist(), w):
        adj[s].append((d, x))
    return adj


def _queue_bfs(adj, root):
    level = [-1] * len(adj)
    level[root] = 0
    q = deque([root])
    while q:
        u = q.popleft()
        for v, _ in adj[u]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    return level


def _dijkstra(adj, root):
    dist = [float("inf")] * len(adj)
    dist[root] = 0.0
    heap = [(0.0, root)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, w in adj[u]:
            if d + w < dist[v]:
                dist[v] = d + w
                heapq.heappush(heap, (dist[v], v))
    return dist


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_bfs_reference_equals_queue_bfs(name, seed):
    g = _generate(name, 9, seed, weights="uniform01_per_undirected_edge")
    adj = _adjacency(g)
    for root in (0, int(g["src"][len(g["src"]) // 2])):
        got = _ref("bfs").solve(g["src"], g["dst"], g["weights"], g["num_vertices"], root, {})
        assert got.tolist() == _queue_bfs(adj, root)


@pytest.mark.parametrize("name", CONFIGS)
def test_sssp_reference_equals_dijkstra(name):
    g = _generate(name, 9, 5, weights="uniform01_per_undirected_edge")
    adj = _adjacency(g)
    for root in (1, int(g["dst"][7])):
        got = _ref("sssp").solve(g["src"], g["dst"], g["weights"], g["num_vertices"], root, {})
        want = np.array(_dijkstra(adj, root))
        got = got.numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0)


def test_pagerank_reference_equals_vertex_loop():
    g = _generate("graph500-kron-s20", 8, 9)
    n, d, iters = g["num_vertices"], 0.85, 20
    src, dst = g["src"].tolist(), g["dst"].tolist()
    outdeg = np.bincount(src, minlength=n)
    into = [[] for _ in range(n)]
    for s, t in zip(src, dst):
        into[t].append(s)
    rank = [1.0 / n] * n
    for _ in range(iters):
        rank = [(1 - d) / n + d * sum(rank[s] / outdeg[s] for s in into[v]) for v in range(n)]
    got = _ref("pagerank").solve(g["src"], g["dst"], None, n, None,
                                 {"damping": d, "iterations": iters})
    np.testing.assert_allclose(got.numpy(), rank, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_generators_repeat_for_a_seed_and_differ_across_seeds(name):
    a = _generate(name, 10, 2**31 + 5, weights="uniform01_per_undirected_edge")
    b = _generate(name, 10, 2**31 + 5, weights="uniform01_per_undirected_edge")
    c = _generate(name, 10, 2**31 + 6, weights="uniform01_per_undirected_edge")
    for k in ("src", "dst", "weights"):
        assert torch.equal(a[k], b[k])
    assert a["src"].shape != c["src"].shape or not torch.equal(a["dst"], c["dst"])


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel1_graph_is_simple_and_symmetric_with_shared_weights(name):
    g = _generate(name, 10, 17, weights="uniform01_per_undirected_edge")
    n = g["num_vertices"]
    src, dst, w = g["src"].numpy(), g["dst"].numpy(), g["weights"].numpy()
    assert not (src == dst).any()
    key = src * n + dst
    assert len(np.unique(key)) == len(key)
    back = dict(zip(key.tolist(), w.tolist()))
    assert all(back[d * n + s] == x for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()))
    assert ((w >= 0) & (w < 1)).all()


@pytest.mark.parametrize("seed", [23, 2**31 + 29])
def test_kronecker_vertex_labels_are_permuted(seed):
    # unpermuted, a vertex's expected degree falls with the 1-bits of its id
    # (hubs on the lowest ids); permuted, the degree says nothing of the id
    g = _generate("graph500-kron-s20", 12, seed)
    n = g["num_vertices"]
    deg = np.bincount(g["src"].numpy(), minlength=n)
    ones = np.array([bin(v).count("1") for v in range(n)])
    low, high = deg[ones <= 4].mean(), deg[ones >= 8].mean()
    assert 0.7 < low / high < 1.4
    assert int(np.argmax(deg)) != 0


class _Ev:
    def __init__(self, name, start, end, device):
        self.name, self.device_type = name, device
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_device_trace_reduction_on_made_up_events():
    from graphbench.devtrace import reduce_events

    cpu, cuda = "cpu", "cuda"
    events = [
        _Ev("graphbench.solve.bfs", 0, 100, cpu),
        _Ev("graphbench.solve.bfs", 10, 90, cuda),  # a range's device-side copy: not busy
        _Ev("aten::item", 50, 70, cpu),
        _Ev("k1", 10, 20, cuda),
        _Ev("k1", 15, 30, cuda),  # overlaps the first: the union counts 20 us
        _Ev("k2", 60, 65, cuda),
    ]
    got = reduce_events(events, cuda)
    assert got["device_events"] == 3
    assert got["busy_s"] == pytest.approx(25e-6)
    assert got["kernels"]["k1"] == {"events": 2, "seconds": pytest.approx(25e-6)}
    assert got["device_ops"][0][0] == "k1"
    # the one gap (30-60 us): Python in the solve range, then aten::item
    assert got["idle_gaps"] == [["python solve.bfs, next aten::item", pytest.approx(30e-6)]]
