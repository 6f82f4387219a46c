"""Model FLOPs of the requests answered in the window (the tower and
projector over their frames, 2 a weight a token through the decoder, causal
attention, the head at each generated token) over the window's length times
the chip's bf16 peak, in percent."""
from portbench import roofline


def read(ctx, name):
    if not ctx.answered:
        return None
    flops = sum(roofline.serve_flops(ctx.n, r["tokens"],
                                     0 if r["req"]["frames"] is None else len(r["req"]["frames"]),
                                     len(r["result"].token_ids)) for r in ctx.answered)
    span = max(r["done"] for r in ctx.answered) - ctx.t_open
    return 100.0 * flops / (span * roofline.PEAK_FLOPS)
