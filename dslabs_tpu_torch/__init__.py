"""PyTorch/CUDA port of the tensor model checker (``dslabs_tpu/tpu``).

The JAX package ``dslabs_tpu`` stays the reference; this package imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of ``dslabs_tpu``.
"""
