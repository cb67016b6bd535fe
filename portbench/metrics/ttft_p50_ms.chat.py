"""ttft_p50_ms.chat (serve.engine): the median over the requests due in
the window of the time from a request's due time to the end of the step
that delivered its first token (host clock), over those whose first token
came before a profiler first recorded a step there: under CUDA tracing, and
after it, the host dispatches a prefill several times slower, so a traced
run's later requests read its cost.  Per layer, not end to end: the eager
prefill it waits for is paced by the host's dispatch, so it follows the
speed of a shared host from run to run by more than any bound the
benchmark may set (PERF.md §2).  None in a traced run where the program
keeps no step records, or where no such request falls in the window."""

import statistics


def _first_profiled(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None if ctx.trace is not None else float("inf")
    return min((s.t0 for s in TELEMETRY.steps(*ctx.tl.window) if s.profiled),
               default=float("inf"))


def read(ctx):
    until = _first_profiled(ctx)
    if until is None:
        return None
    ends = ctx.tl.step_ends
    ttft = [ends[s.admit_step] - s.due for s in ctx.tl.finished() if ends[s.admit_step] < until]
    return 1e3 * statistics.median(ttft) if ttft else None
