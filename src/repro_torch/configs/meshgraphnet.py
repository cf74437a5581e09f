"""meshgraphnet [gnn] n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
[arXiv:2010.03409; unverified]. Counterpart of ``repro.configs.meshgraphnet``,
value for value."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.archs import GNNConfig


def _smoke():
    return GNNConfig(name="meshgraphnet", n_layers=3, d_hidden=16, mlp_layers=2)


ARCH = ArchConfig(
    arch_id="meshgraphnet",
    family="gnn",
    model=GNNConfig(
        name="meshgraphnet", n_layers=15, d_hidden=128, aggregator="sum",
        mlp_layers=2,
    ),
    shapes=GNN_SHAPES,
    source="arXiv:2010.03409; unverified",
    gnn_task="node_reg",
    gnn_out_dim=2,
    smoke=_smoke,
)
