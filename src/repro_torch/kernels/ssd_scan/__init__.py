"""Mamba2 SSD chunked scan (K5): CUDA launcher, plain version, ops."""
