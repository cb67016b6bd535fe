"""slot_occupancy (serve.engine): live slots over all slots, averaged over
the decode steps that ended inside the window."""


def read(ctx):
    live = ctx.tl.live_per_step()[ctx.in_window()]
    steps = int((live > 0).sum())
    if not steps:
        return None
    return 100.0 * float(live.sum()) / (steps * ctx.slots)
