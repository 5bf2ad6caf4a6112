"""kNN score (fedmse_tpu_torch/knn/score.py -> csrc/dist_tiles.cu): the
distance kernel's share of its roofline at the evaluation's launch, every
gateway's test rows against its own bank. The least time
(benchmark/roofline.dist_bound) over the kernel's time per call, by CUDA
events around replays of a graph of 16 calls. In %. None unless the
configuration scores by kNN."""

from benchmark import roofline


def read(ctx):
    if not ctx.on_card or ctx.config["score_kind"] != "knn":
        return None
    import torch
    from fedmse_tpu_torch.knn.score import dist_tiles
    from fedmse_tpu_torch.ops.fused_ae import client_index
    sh = ctx.shapes
    n, t, bank, lat = sh["gateways"], sh["test_rows"], sh["bank"], \
        ctx.dims[2]
    g = torch.Generator(device=ctx.device).manual_seed(3)
    q = torch.randn((n * t, lat), generator=g, device=ctx.device)
    banks = torch.randn((n, bank, lat), generator=g, device=ctx.device)
    gw = client_index(n, t, ctx.device)
    ms = roofline.graph_ms(lambda: dist_tiles(q, banks, gw))
    least, _ = roofline.dist_bound(n * t, bank, n, lat)
    return 100.0 * least / ms
