"""decode_mfu.moe (serve.graph): the whole decode step's share of the
chip's peak, for a decoder of latent attention and routed experts.  Over
every step that decoded: the least time of the step's needs
(``pb.costs_moe.decode_step_need``: the weights but the routed experts',
the experts that held a token that step by the engine's counters, each
live row's latent cache up to its fill, activations; bytes at 3.35 TB/s
against FLOPs at 989 TFLOP/s, the larger) summed, over the engine's decode
seconds summed.  None where the program keeps no MoE step counters."""

from pb import costs_moe


def read(ctx):
    records = costs_moe.step_records(ctx)
    if records is None or getattr(ctx.cfg, "mla", None) is None:
        return None
    need = 0.0
    for rows, rec in zip(ctx.decode_rows(), records):
        if not rows:
            continue
        counts = getattr(rec, "moe_decode", None)
        if counts is None:
            return None
        need += ctx.costs.roof_s(*costs_moe.decode_step_need(ctx.cfg, rows, counts.experts))
    took = sum(r.decode_s for r in ctx.tl.finished())
    return ctx.costs.share_pct(need, took) if need > 0 else None
