"""EXTRA pool arch (beyond assignment): gcn [arXiv:1609.02907]
2 layers, hidden 16, symmetric-normalized SpMM convolution. Counterpart of
``repro.configs.gcn_cora``, value for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="gcn", n_layers=2, d_hidden=8)


ARCH = ArchConfig(
    arch_id="gcn-cora",
    family="gnn",
    model=GNNConfig(name="gcn", n_layers=2, d_hidden=16),
    shapes=GNN_SHAPES,
    source="arXiv:1609.02907; paper (extra, beyond assignment)",
    gnn_task="node_class",
    gnn_out_dim=7,
    smoke=_smoke,
)
