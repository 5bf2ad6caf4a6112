"""Local training of KitNET (fedmse_tpu_torch/federation/local_training.py
-> csrc/kitnet.cu's train kernel): the train kernel's share of its
roofline at the cell's step, the cohort's clients each with one batch
under the run's own feature map: the least time
(benchmark/roofline_kitnet.train_bound) over the kernel's time per call,
by CUDA events around replays of a graph of 16 calls, each on its own
inputs of those shapes (params, statistics, rows and mask; benchmark/
roofline.graph_ms). In %. None off the card, and where the program has
no KitNET kernel or the window names no feature map."""

from benchmark import roofline, roofline_kitnet


def read(ctx):
    fmap = ctx.window.get("feature_map")
    if not ctx.on_card or not fmap:
        return None
    try:
        from fedmse_tpu_torch.models.flat import KitnetLayout
        from fedmse_tpu_torch.ops.kitnet import kitnet_train_grads
    except ImportError:
        return None
    import torch
    s, b = ctx.shapes["cohort"], ctx.shapes["batch"]
    beta = float(ctx.config.get("kitnet_hidden_ratio", 0.75))
    layout = KitnetLayout(tuple(tuple(c) for c in fmap), beta)
    d, k, dev = layout.dim, layout.k, ctx.device
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs():
        lo = torch.rand((s, k), generator=g, device=dev) * 0.2
        return dict(
            params=(torch.rand((s, layout.size), generator=g, device=dev)
                    - 0.5) * 0.2,
            stats=torch.cat([lo, lo + 0.5], dim=1),
            x=torch.rand((s, b, d), generator=g, device=dev),
            m=torch.ones((s, b), device=dev))

    sets = [inputs() for _ in range(roofline.GRAPH_CALLS)]
    calls = [0]

    def call():
        a = sets[calls[0] % len(sets)]
        calls[0] += 1
        kitnet_train_grads(a["params"], a["stats"], a["x"], a["m"],
                           layout=layout)

    ms = roofline.graph_ms(call)
    least, _ = roofline_kitnet.train_bound(b, s, layout.feature_map, beta)
    return 100.0 * least / ms
