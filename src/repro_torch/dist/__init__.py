"""Distributed pieces of the port. Only the crossbar embedding lookup
(``dist.embedding``) so far, at one shard."""
