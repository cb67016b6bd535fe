"""Flash-attention forward (K4): CUDA launcher, plain version, ops."""
