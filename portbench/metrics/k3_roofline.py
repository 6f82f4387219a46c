"""K3's share of its roofline in the traced sub-window: the least time the
tower's full attention needs over the frames encoded there (each encode
batch of ``vision_chunk`` tiles, all layers) over the device time of K3's
kernels there, in percent."""
from portbench import roofline
from portbench.metrics import is_k3, traced_iterations


def read(ctx, name):
    bound = 0.0
    per = ctx.vision_chunk
    for it in traced_iterations(ctx):
        rec = it["admit"]
        if rec is None or rec["req"]["frames"] is None:
            continue
        tiles = len(rec["req"]["frames"])
        for t0 in range(0, tiles, per):
            bound += roofline.bound_s(*roofline.vit_attn(ctx.n, min(per, tiles - t0)))
    t = ctx.trace.kernel_s(is_k3) if ctx.trace is not None else 0.0
    return 100.0 * bound / t if bound and t else None
