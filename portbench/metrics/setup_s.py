"""setup_s: process start to the window's open: imports, the kernels'
build (first run in a checkout), the weights, the warm-up and the graph
captures."""


def read(ctx):
    return ctx.setup_s
