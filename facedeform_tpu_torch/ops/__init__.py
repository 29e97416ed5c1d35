"""Numerical operations of the PyTorch port: kernels, assembly, solve, fit,
plain eval and the CUDA eval kernels' wrappers."""
