"""decode_mfu (serve.graph): the whole decode step's share of the chip's
peak.  Over every step that decoded: the least time of the step's needs
(the weights read once, each live row's activations, cache rows up to its
fill; bytes at 3.35 TB/s against FLOPs at 989 TFLOP/s, the
larger) summed, over the engine's decode seconds summed."""


def read(ctx):
    need = sum(ctx.costs.roof_s(*ctx.costs.decode_step_cost(ctx.cfg, rows))
               for rows in ctx.decode_rows() if rows)
    took = sum(r.decode_s for r in ctx.tl.finished())
    return ctx.costs.share_pct(need, took) if need > 0 else None
