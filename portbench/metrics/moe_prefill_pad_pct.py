"""moe_prefill_pad_pct (models): the expert rows the prefills' expert
GEMMs computed in vain, over the steps that ended inside the window: 100 x
(1 - real expert rows / rows computed) over their MoE layer launches, from
the engine's own counters (K6 rounds each expert's counted rows up to its
row tile; without the count skip every expert would compute every token's
row).  None where the program keeps no MoE counters or no prefill fell in
the window."""


def read(ctx):
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    counts = [getattr(s, "moe_prefill", None) for s in TELEMETRY.steps(*ctx.tl.window)]
    counts = [c for c in counts if c is not None and c.launches]
    computed = sum(c.computed for c in counts)
    if computed <= 0:
        return None
    return 100.0 * (1.0 - sum(c.rows for c in counts) / computed)
