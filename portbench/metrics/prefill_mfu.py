"""prefill_mfu (models: the eager Model.prefill): FLOPs of the real
prompt tokens admitted (each prompt alone: no pad columns, no dummy rows)
over 989 TFLOP/s times the admissions' prefill seconds."""


def read(ctx):
    done = ctx.tl.finished()
    took = sum(r.prefill_s for r in done)
    if took <= 0:
        return None
    flops = ctx.costs.prefill_flops(ctx.cfg, [r.prompt_len for r in done])
    return ctx.costs.share_pct(flops / ctx.costs.PEAK_FLOPS_BF16, took)
