"""The whole round, apart from how many epochs it trains: the window's
seconds over the epochs of local training its rounds ran
(`FusedRound.epochs_run`), in ms per epoch. Early stops set the epochs a
round runs, and they move with the seed; this reads the speed without
that count."""


def read(ctx):
    w = ctx.window
    if not ctx.on_card or not w["epochs"]:
        return None
    return 1e3 * w["window_s"] / w["epochs"]
