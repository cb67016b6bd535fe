"""prefill_pad_pct (serve.engine): the share of the prefilled tokens that
were padding, over the steps that ended inside the window: 100 x (1 -
the real prompt tokens / the rows x padded length prefilled), from the
engine's own step records (``repro_torch.serve.telemetry``).  None where
the program keeps no such records or none falls in the window."""


def read(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    steps = TELEMETRY.steps(*ctx.tl.window)
    padded = sum(s.prefill_tokens for s in steps)
    if padded <= 0:
        return None
    return 100.0 * (1.0 - sum(s.prompt_tokens for s in steps) / padded)
