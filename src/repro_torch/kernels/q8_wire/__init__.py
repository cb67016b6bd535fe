"""The block-int8 wire's round trip: CUDA launcher, plain version, ops."""
