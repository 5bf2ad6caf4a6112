"""Device: the share of the traced span (two whole rounds inside the
window, benchmark/trace.py) in which no operation ran on the card, from
torch.profiler's device activity: 1 - busy / span. In %."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
