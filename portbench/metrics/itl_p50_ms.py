"""itl_p50_ms: the median gap between two tokens of one request, pooled
over every token after the first of every request due in the window (host
clock at the ends of the steps that delivered them)."""


def read(ctx):
    return ctx.summary.get("itl_p50_ms")
