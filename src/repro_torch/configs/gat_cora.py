"""gat-cora [gnn] n_layers=2 d_hidden=8 n_heads=8 aggregator=attn
[arXiv:1710.10903; paper]. Counterpart of ``repro.configs.gat_cora``, value
for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="gat", n_layers=2, d_hidden=4, n_heads=2, aggregator="attn")


ARCH = ArchConfig(
    arch_id="gat-cora",
    family="gnn",
    model=GNNConfig(
        name="gat", n_layers=2, d_hidden=8, n_heads=8, aggregator="attn"
    ),
    shapes=GNN_SHAPES,
    source="arXiv:1710.10903; paper",
    gnn_task="node_class",
    gnn_out_dim=7,
    smoke=_smoke,
)
