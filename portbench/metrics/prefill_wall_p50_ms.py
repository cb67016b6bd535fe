"""prefill_wall_p50_ms (serve.engine): the median over the requests whose
first token reached the host inside the window of the time from the start
of their own prefill group to that read-back, from the engine's own
request records (``repro_torch.serve.telemetry``): the wait for a
request's own prefill, without the step in flight when it came due.  None
where the program keeps no such records or none falls in the window."""

import statistics


def read(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    walls = [r.t_first - r.t_admit for r in TELEMETRY.requests(*ctx.tl.window)]
    return 1e3 * statistics.median(walls) if walls else None
