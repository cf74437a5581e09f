"""PyTorch/CUDA port of the GraphScale engine (``repro`` is the JAX reference).

Module paths mirror ``repro``: ``core.graph``, ``core.problems``,
``core.partition``, ``core.frontier_words``, ``core.engine``,
``kernels.csr_gather_reduce``, ``serve``, ``data.synthetic`` (the serving
generators) and ``launch.serve`` (graph mode). The package imports torch and
numpy only — never jax and never ``repro``.
"""
