"""schnet [gnn] n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566; paper]. Counterpart of ``repro.configs.schnet``, value
for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="schnet", n_layers=2, d_hidden=16, rbf=20, cutoff=10.0)


ARCH = ArchConfig(
    arch_id="schnet",
    family="gnn",
    model=GNNConfig(name="schnet", n_layers=3, d_hidden=64, rbf=300, cutoff=10.0),
    shapes=GNN_SHAPES,
    source="arXiv:1706.08566; paper",
    gnn_task="node_reg",
    gnn_out_dim=1,
    smoke=_smoke,
)
