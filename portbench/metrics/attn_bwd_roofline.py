"""The attention backward's share of its roofline in the traced training
steps: the least time the backward over each packed sample needs (four
products a pair, each layer) over the device time of K4's and K5's kernels,
in percent."""
from portbench import roofline
from portbench.metrics import is_attn_bwd


def read(ctx, name):
    if ctx.trace is None or ctx.traced is None:
        return None
    a, b = ctx.traced
    bound = sum(ctx.n["l"] * roofline.bound_s(*roofline.attn_bwd(ctx.n, e - s))
                for row in ctx.rows[a:b] for s, e in row["segments"])
    t = ctx.trace.kernel_s(is_attn_bwd)
    return 100.0 * bound / t if bound and t else None
