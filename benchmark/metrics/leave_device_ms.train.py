"""Vote, merge, verification, evaluation and the kNN score (the fused
round's `leave` body, fedmse_tpu_torch/federation/fused.py): its device
ms a round, from the program's round ledger (utils/profiling.py) over the
window's chunks. In ms a round. None off the card or where the program
keeps no ledger."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from fedmse_tpu_torch.utils.profiling import ledger_window
    except ImportError:  # a program without the ledger
        return None
    w = ledger_window(ctx.window["t_open"], ctx.window["window_s"])
    if w is None:
        return None
    return w["leave_ms"] / w["rounds"]
