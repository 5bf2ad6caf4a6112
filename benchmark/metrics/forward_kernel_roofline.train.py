"""Vote, merge, verification and evaluation (fedmse_tpu_torch/federation/
{voting,aggregation,verification}.py, evaluation/evaluator.py ->
csrc/fused_ae.cu): the forward kernel's share of its roofline at the
round's largest launch, the evaluation's: every gateway's test rows (and,
for the kNN score, its train rows) routed client-major to its own model.
The least time (benchmark/roofline.forward_bound) over the kernel's time
per call, by CUDA events around replays of a graph of 16 calls. In %."""

from benchmark import roofline


def read(ctx):
    if not ctx.on_card:
        return None
    import torch
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_ae import client_index, \
        fused_forward_stats
    sh = ctx.shapes
    n, d = sh["gateways"], ctx.dims[0]
    per = sh["test_rows"] + (sh["train_rows_padded"]
                             if ctx.config["score_kind"] == "knn" else 0)
    layout = ParamLayout(*ctx.dims)
    g = torch.Generator(device=ctx.device).manual_seed(2)
    flat = (torch.rand((n, layout.size), generator=g, device=ctx.device)
            - 0.5) * 0.2
    params = layout.tree(flat)
    x = torch.randn((n * per, d), generator=g, device=ctx.device)
    idx = client_index(n, per, ctx.device)
    ms = roofline.graph_ms(lambda: fused_forward_stats(params, x, idx))
    least, _ = roofline.forward_bound(n * per, n, ctx.precision, ctx.dims)
    return 100.0 * least / ms
