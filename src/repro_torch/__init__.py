"""GreenLLM's serving path in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a).

A port of the JAX package `repro` (src/repro/), which stays the reference:
the same modules at the same relative paths, held to the reference's output
by tests/test_torch_*.py. This package imports neither JAX nor `repro`.
"""
