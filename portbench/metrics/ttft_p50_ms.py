"""ttft_p50_ms: the median over every request due in the window of the
time from its due time to the end of the step that delivered its first
token (host clock)."""


def read(ctx):
    return ctx.summary.get("ttft_p50_ms")
