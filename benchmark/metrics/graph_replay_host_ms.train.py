"""Round engine and graphs (fedmse_tpu_torch/federation/{rounds,fused}.py,
ops/graphs.py): the host's seconds inside the fused round's graph replays
(`CapturedBody.replay_seconds` of `enter`, `epoch` and `leave`, summed
over the window), in ms per round."""


def read(ctx):
    if not ctx.on_card or not ctx.window["rounds"]:
        return None
    return 1e3 * ctx.window["graph_replay_s"] / ctx.window["rounds"]
