"""moe_gmm_roofline_pct (kernels): K6's share of its roofline in the
traced window.  The need of the window's K6 calls, from the engine's MoE
counters of every step a profiler recorded, prefill and decode apart
(``pb.costs_moe.gmm_need``: each expert that held a token reads its three
weights, 3 x 2,048 x 1,408 x 2 B, and each real row goes in and out of the
three GEMMs; FLOPs 2 x rows x 3 x 2,048 x 1,408), over K6's device seconds
in the trace (its kernels by name).  None without a trace, without the
program's MoE counters, or where no K6 kernel ran."""

from pb import costs_moe


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch.serve.telemetry import TELEMETRY
    except ImportError:
        return None
    steps = [s for s in TELEMETRY.step_log if s.profiled]
    if not steps or not hasattr(steps[0], "moe_decode"):
        return None
    need = sum(costs_moe.gmm_roof_s(ctx.cfg, s.moe_prefill)
               + costs_moe.gmm_roof_s(ctx.cfg, s.moe_decode) for s in steps)
    took = costs_moe.k6_seconds(ctx.trace)
    return ctx.costs.share_pct(need, took) if need > 0 and took > 0 else None
