"""Host milliseconds of a scheduler iteration that ran a decode tick of the
slot pool (its ``tick`` steps over every slot, with the prompt chunk or
admission that rode in the same iteration), as ``ContinuousBatcher.trace``
marks them, outside the traced sub-window: the profiler slows a host-bound
step."""


def read(ctx, name):
    lo, hi = (ctx.trace.t0, ctx.trace.t1) if ctx.trace is not None else (0.0, 0.0)
    ticks = [it["t1"] - it["t0"] for it in ctx.iterations
             if "tick" in it["acts"] and (it["t1"] <= lo or it["t0"] >= hi)]
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
