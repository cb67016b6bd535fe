"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel.

Layout as in ``repro.kernels``: ``<name>/<name>.py`` is the launcher of the
CUDA kernel in ``../csrc/<name>.cu``, ``<name>/ref.py`` the plain PyTorch
version, ``<name>/ops.py`` the wrapper that dispatches on the tensor's
device — the plain version for a CPU tensor, the kernel for a CUDA tensor.
"""
