"""Hand-written CUDA kernels for Hopper (sm_90a) on the serving hot path.

Each kernel module holds the `ctypes` wrapper of its kernel (sources in
``csrc/``, built by ``build.py`` at first use) beside a plain PyTorch version
of the same function; ``ops.py`` is the front door in the model's layouts and
``ref.py`` holds fp32 oracles for the tests.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
