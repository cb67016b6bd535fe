"""The BOTS fib leaf's busy loop: CUDA launcher, plain version, ops."""
