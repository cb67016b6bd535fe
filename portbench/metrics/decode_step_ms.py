"""decode_step_ms (serve.graph): the engine's decode seconds
(``Result.decode_s`` summed over every request) over the steps that
decoded."""


def read(ctx):
    steps = int((ctx.tl.live_per_step() > 0).sum())
    s = sum(r.decode_s for r in ctx.tl.finished())
    return 1e3 * s / steps if steps and s > 0 else None
