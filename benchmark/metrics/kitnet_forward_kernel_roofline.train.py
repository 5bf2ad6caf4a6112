"""Vote, verification and evaluation of KitNET (fedmse_tpu_torch/
federation/{voting,verification}.py, evaluation/evaluator.py ->
csrc/kitnet.cu's forward kernel): the forward kernel's share of its
roofline at the round's largest launch, the evaluation's (every
gateway's test rows routed client-major to its own model) under the
run's own feature map: the least time (benchmark/roofline_kitnet.
forward_bound) over the kernel's time per call, by CUDA events around
replays of a graph of 16 calls, each with its own params and statistics
(the rows, hundreds of megabytes, are read from device memory by every
call). In %. None off the card, and where the program has no KitNET
kernel or the window names no feature map."""

from benchmark import roofline, roofline_kitnet


def read(ctx):
    fmap = ctx.window.get("feature_map")
    if not ctx.on_card or not fmap:
        return None
    try:
        from fedmse_tpu_torch.models.flat import KitnetLayout
        from fedmse_tpu_torch.ops.fused_ae import client_index
        from fedmse_tpu_torch.ops.kitnet import (KitnetParams,
                                                 kitnet_forward_stats)
    except ImportError:
        return None
    import torch
    n, t = ctx.shapes["gateways"], ctx.shapes["test_rows"]
    beta = float(ctx.config.get("kitnet_hidden_ratio", 0.75))
    layout = KitnetLayout(tuple(tuple(c) for c in fmap), beta)
    k, dev = layout.k, ctx.device
    g = torch.Generator(device=dev).manual_seed(2)

    def models():
        lo = torch.rand((n, k), generator=g, device=dev) * 0.2
        flat = (torch.rand((n, layout.size), generator=g, device=dev)
                - 0.5) * 0.2
        return KitnetParams(flat, torch.cat([lo, lo + 0.5], dim=1), layout)

    sets = [models() for _ in range(roofline.GRAPH_CALLS)]
    x = torch.rand((n * t, layout.dim), generator=g, device=dev)
    idx = client_index(n, t, dev)
    calls = [0]

    def call():
        params = sets[calls[0] % len(sets)]
        calls[0] += 1
        kitnet_forward_stats(params, x, idx)

    ms = roofline.graph_ms(call)
    least, _ = roofline_kitnet.forward_bound(n * t, n, layout.feature_map,
                                             beta)
    return 100.0 * least / ms
