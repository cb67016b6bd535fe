"""Flash decode (K3): CUDA launcher, plain version, ops."""
