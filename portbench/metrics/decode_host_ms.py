"""decode_host_ms (serve.engine): the host's own time in a decode step:
the mean of the step's length (``t1 - t0``) less its wait for the decode
on the card (from the launch call's return to the end of the wait,
``t_synced - t_launch``), from the engine's own step records
(``repro_torch.serve.telemetry``), over the steps that ended inside the
window, decoded and admitted nobody, and ended before a profiler first
recorded a step there.  In a ``--trace 1`` run the rest is left out: under
CUDA tracing a graph launch call alone takes milliseconds, and it stays
slower after the profiler stops.  None where the program keeps no such
records or no such step falls in the window."""


def read(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    steps = TELEMETRY.steps(*ctx.tl.window)
    until = min((s.t0 for s in steps if s.profiled), default=float("inf"))
    host = [(s.t1 - s.t0) - (s.t_synced - s.t_launch) for s in steps
            if s.decode_rows > 0 and s.prefill_tokens == 0 and s.t1 < until]
    return 1e3 * sum(host) / len(host) if host else None
