"""hoig_torch: the PyTorch/CUDA port of hoig_tpu for NVIDIA Hopper.

Mirrors hoig_tpu's subpackages and function names. It imports neither JAX
nor hoig_tpu; hand-written CUDA kernels live in `csrc/` and are built at
first use (ops/_cuda.py).
"""
