"""Paper-native GraphScale configuration (Table II parameterization).

Counterpart of ``repro.configs.graphscale``, value for value. FPGA -> port
mapping:
  * 4 memory channels            -> p = 4 graph cores (one rank each in
                                    ``core.distributed``)
  * vertex label scratch 2^21    -> scratch_size = 2**21 labels per core-phase
  * 16 scratch-pad banks         -> the ``lane`` alignment of sub_size
  * 8 vertex pipelines           -> edge-tile width Eb of the gather kernel
  * reorder depth 32             -> crossbar capacity factor (dist/embedding)
  * stride mapping stride 100    -> PartitionConfig.stride
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.partition import PartitionConfig

__all__ = ["PAPER_SCRATCH_LABELS", "PAPER_STRIDE", "PAPER_CHANNELS", "paper_partition_config",
           "KernelTiling", "PAPER_KERNEL_TILING"]

PAPER_SCRATCH_LABELS = 1 << 21
PAPER_STRIDE = 100
PAPER_CHANNELS = 4


def paper_partition_config(
    p: int = PAPER_CHANNELS,
    stride: int | None = PAPER_STRIDE,
    lane: int = 8,
) -> PartitionConfig:
    return PartitionConfig(
        p=p, l=1, lane=lane, stride=stride, scratch_size=PAPER_SCRATCH_LABELS
    )


@dataclasses.dataclass(frozen=True)
class KernelTiling:
    """Accumulator tile parameters of the gather kernel
    (``csrc/gather_reduce_cores.cu``), the reference's values:

      * ``vb``: rows of one row block, ``PartitionConfig.tile_vb``: the
        ``vb`` argument of ``gather_reduce_cores``, the rows of the
        shared-memory accumulator one thread block owns (at most
        ``kernel.smem_limit_rows()``);
      * ``eb``: slots of one edge tile, ``PartitionConfig.tile_eb``: the
        innermost axis of the (p, R, T, Eb) word stream, which a block walks
        tile by tile."""

    vb: int = 128  # rows per output block
    eb: int = 1024  # edges per tile


PAPER_KERNEL_TILING = KernelTiling()
