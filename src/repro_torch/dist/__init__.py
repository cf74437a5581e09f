"""Distributed pieces of the port: the crossbar embedding lookup
(``dist.embedding``, at one shard or over process groups) and GNN feature
aggregation and GAT training over the phased crossbar (``dist.gnn_parallel``,
``dist.gat_parallel``)."""
