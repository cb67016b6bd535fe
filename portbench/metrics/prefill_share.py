"""prefill_share (serve.engine): the admissions' prefill seconds
(``Result.prefill_s`` summed over the requests admitted in steps that ended
inside the window) over the window's seconds."""


def read(ctx):
    lo, hi = ctx.tl.window
    ends = ctx.tl.step_ends
    s = sum(r.prefill_s for r in ctx.tl.finished() if lo <= ends[r.admit_step] <= hi)
    return 100.0 * s / (hi - lo) if s > 0 else None
