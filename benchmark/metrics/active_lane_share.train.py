"""Local training (fedmse_tpu_torch/federation/local_training.py): the
share of the train lanes replayed (the launch width x the epochs
replayed, the speculative epoch included) in which a selected client was
still active (its `tracking` active column), from the program's round
ledger (utils/profiling.py) over the window's chunks. In %. None off the
card or where the program keeps no ledger."""


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
    return 100.0 * w["active_lanes"] / w["lanes"] if w["lanes"] else None
