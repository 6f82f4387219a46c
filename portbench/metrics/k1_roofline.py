"""K1's share of its roofline in the traced sub-window: the least time the
prompt chunks that ran there need for their causal attention (each layer's
call bounded by the larger of its operations and bytes over the chip's
peaks; true rows only, whatever the padding) over the device time of K1's
kernels there, in percent."""
from portbench import roofline
from portbench.metrics import is_k1, traced_iterations


def read(ctx, name):
    bound = 0.0
    for it in traced_iterations(ctx):
        if it["chunk"] is None:
            continue
        rec, k = it["chunk"]
        r0 = k * ctx.chunk
        r1 = min(r0 + ctx.chunk, rec["tokens"])
        if r1 > r0:
            bound += ctx.n["l"] * roofline.bound_s(*roofline.attn_fwd(ctx.n, r0, r1))
    t = ctx.trace.kernel_s(is_k1) if ctx.trace is not None else 0.0
    return 100.0 * bound / t if bound and t else None
