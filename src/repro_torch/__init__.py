"""PyTorch/CUDA port of the GraphScale engine (``repro`` is the JAX reference).

Module paths mirror ``repro``: ``core.graph``, ``core.problems``,
``core.partition``, ``core.frontier_words``, ``core.engine``,
``kernels.{csr_gather_reduce,embedding_bag,segment_softmax,flash_attention}``,
``serve``, ``models.{layers,transformer}`` (the LM family),
``models.gnn``, ``models.recsys.din``, ``configs`` (the LM, GNN and DIN
archs), ``dist.embedding`` (the crossbar lookup), ``data.synthetic``,
``train`` and ``launch.{serve,train}``. The package imports torch and numpy
only — never jax and never ``repro``.
"""
