"""Device, untraced: the share of the window's device time in which the
card ran no body of the fused round, from the program's own round ledger
(fedmse_tpu_torch/utils/profiling.py, marker events around every body
replay in federation/fused.py, resolved after each harvest). Over the
chunks dispatched and harvested inside the window: 1 - body ms / (body
ms + idle ms), the idle inside rounds, at round edges and at the edges
between two of those chunks. In %. None off the card or where the
program keeps no ledger."""


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
    body = sum(w[k] for k in ("enter_ms", "train_ms", "speculative_ms",
                              "leave_ms"))
    idle = sum(w[k] for k in ("idle_in_round_ms", "idle_round_edge_ms",
                              "idle_chunk_edge_ms"))
    return 100.0 * idle / (body + idle) if body + idle > 0 else None
