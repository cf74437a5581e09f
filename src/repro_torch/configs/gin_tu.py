"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper]. Counterpart of ``repro.configs.gin_tu``, value
for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="gin", n_layers=2, d_hidden=16)


ARCH = ArchConfig(
    arch_id="gin-tu",
    family="gnn",
    model=GNNConfig(
        name="gin", n_layers=5, d_hidden=64, aggregator="sum", eps_learnable=True
    ),
    shapes=GNN_SHAPES,
    source="arXiv:1810.00826; paper",
    gnn_task="graph_class",
    gnn_out_dim=2,
    smoke=_smoke,
)
