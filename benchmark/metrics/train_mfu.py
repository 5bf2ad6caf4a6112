"""The whole round: the FLOPs the window's rounds need at the cell's
shapes (benchmark/roofline.round_flops: the cohort's trained rows, every
forwarded row, the kNN distances), over the window's seconds and the
published peak of the configuration's precision. In %."""

from benchmark import roofline


def read(ctx):
    w = ctx.window
    if not ctx.on_card or not w["rounds"]:
        return None
    flops = ctx.flops_per_round * w["rounds"]
    return 100.0 * flops / w["window_s"] / roofline.PEAK_FLOPS[ctx.precision]
