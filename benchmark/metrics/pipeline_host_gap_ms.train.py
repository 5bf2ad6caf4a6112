"""Driver layer (fedmse_tpu_torch/federation/pipeline.py): the host's gap
at the window's chunk boundaries, in ms per round. `PipelineStats`
records, at each boundary, the next chunk's dispatch time less the
previous chunk's harvest time; a positive gap is time in which the card
may have waited for the next dispatch. None when the window has no
boundary."""


def read(ctx):
    gaps = ctx.window["pipeline"]["host_gap_s"]
    if not gaps or not ctx.window["rounds"]:
        return None
    return 1e3 * sum(g for g in gaps if g > 0) / ctx.window["rounds"]
