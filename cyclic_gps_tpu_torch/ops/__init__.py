"""Block-tridiagonal engines, small-block algebra and the CUDA kernels."""
