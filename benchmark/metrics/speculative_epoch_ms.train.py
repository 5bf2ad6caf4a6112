"""Round engine (fedmse_tpu_torch/federation/fused.py, the early-stop flag
read one epoch behind the card): the device ms a round of the epoch
replayed after a round's last training epoch, exact and wasted, from the
program's round ledger (utils/profiling.py) over the window's chunks; 0
where every round ran every epoch. In ms a round. None off the card or
where the program keeps no ledger."""


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
    return w["speculative_ms"] / w["rounds"]
