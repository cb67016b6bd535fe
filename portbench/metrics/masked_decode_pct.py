"""masked_decode_pct (serve.graph): the share of the decode steps that
ended inside the window which took the pad-masked decode signature, from
the engine's own step records (``repro_torch.serve.telemetry``).  None
where the program keeps no such records or no decode step falls in the
window."""


def read(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    decoded = [s for s in TELEMETRY.steps(*ctx.tl.window) if s.decode_rows > 0]
    if not decoded:
        return None
    return 100.0 * sum(1 for s in decoded if s.masked) / len(decoded)
