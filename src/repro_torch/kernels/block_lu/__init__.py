"""Sparselu block kernels: CUDA bmod (K2) launcher, plain versions, ops."""
