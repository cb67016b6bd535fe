"""Mandelbrot strip kernel (K1): CUDA launcher, plain version, ops."""
