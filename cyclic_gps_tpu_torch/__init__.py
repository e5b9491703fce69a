"""PyTorch and CUDA port of cyclic_gps_tpu: the LEG Gaussian-process
family and its block-tridiagonal engines, with the TPU kernels rewritten
as CUDA kernels for the H100 (sm_90a).

The JAX package ``cyclic_gps_tpu`` is the reference; this package mirrors
its module layout and function names.  It imports ``torch`` and never
``jax``; the CUDA kernels are built and loaded at first use
(``ops/_build.py``), so every module imports on a machine without a card.
"""
