"""EXTRA pool arch (beyond assignment): GraphSAGE [arXiv:1706.02216]
2 layers, hidden 64, mean aggregator + L2 normalization. Counterpart of
``repro.configs.graphsage``, value for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="sage", n_layers=2, d_hidden=16, aggregator="mean")


ARCH = ArchConfig(
    arch_id="graphsage",
    family="gnn",
    model=GNNConfig(name="sage", n_layers=2, d_hidden=64, aggregator="mean"),
    shapes=GNN_SHAPES,
    source="arXiv:1706.02216; paper (extra, beyond assignment)",
    gnn_task="node_class",
    gnn_out_dim=41,
    smoke=_smoke,
)
