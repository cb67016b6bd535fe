"""Grouped (per-expert) matmul (K6): CUDA launcher, plain version, ops."""
