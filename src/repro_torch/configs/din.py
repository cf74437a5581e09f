"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper]. Counterpart of
``repro.configs.din``, value for value."""
from repro_torch.configs.base import ArchConfig, RECSYS_SHAPES
from repro_torch.models.recsys.din import DINConfig


def _smoke():
    return DINConfig(
        name="din-smoke", embed_dim=8, seq_len=12, attn_mlp=(16, 8),
        out_mlp=(24, 12), item_vocab=500, cate_vocab=20, profile_bag_len=6,
    )


ARCH = ArchConfig(
    arch_id="din",
    family="recsys",
    model=DINConfig(
        name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40),
        out_mlp=(200, 80),
        # 10M items padded to a 512-multiple so the table row-shards over a
        # full mesh
        item_vocab=10_000_384, cate_vocab=10_000,
        profile_bag_len=32,
        # the GraphScale two-level crossbar instead of a full-table gather
        lookup="crossbar",
    ),
    shapes=RECSYS_SHAPES,
    source="arXiv:1706.06978; paper",
    smoke=_smoke,
)
