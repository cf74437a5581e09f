"""PyTorch/CUDA port of the GraphScale engine (``repro`` is the JAX reference).

Module paths mirror ``repro``: ``core.graph``, ``core.problems``,
``core.partition``, ``core.frontier_words``, ``core.engine``,
``kernels.csr_gather_reduce``, ``kernels.embedding_bag``, ``serve``,
``models.recsys.din`` (with ``models.gnn.common``'s MLP helpers),
``configs`` (``din``), ``dist.embedding`` (the crossbar lookup),
``data.synthetic`` (the serving and recsys generators) and ``launch.serve``
(graph and DIN modes). The package imports torch and numpy only — never jax
and never ``repro``.
"""
