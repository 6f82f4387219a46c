"""Model FLOPs of the window's whole steps (portbench/roofline.train_flops:
4 a weight a token for the frozen decoder and head, 6 for the trained
projector, the frozen tower's forward, attention forward and backward inside
each packed sample; no recompute) over their host time times the chip's
bf16 peak, in percent. Traced steps are left out."""
from portbench import roofline


def read(ctx, name):
    a, b = ctx.traced if ctx.traced else (0, 0)
    flops = secs = 0.0
    for k in range(len(ctx.stamps) - 1):
        if a <= k < b:
            continue
        row = ctx.rows[k]
        flops += roofline.train_flops(ctx.n, row["segments"], len(row["sup_pos"]),
                                      len(row["images"]))
        secs += ctx.stamps[k + 1] - ctx.stamps[k]
    return 100.0 * flops / (secs * roofline.PEAK_FLOPS) if secs else None
