"""PyTorch/CUDA port of the GraphScale engine (``repro`` is the JAX reference).

Module paths mirror ``repro``: ``core.graph``, ``core.problems``,
``core.partition``, ``core.engine`` and ``kernels.csr_gather_reduce``. The
package imports torch and numpy only — never jax and never ``repro``.
"""
