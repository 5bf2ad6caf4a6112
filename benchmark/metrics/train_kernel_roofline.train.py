"""Local training (fedmse_tpu_torch/federation/{local_training,optim}.py
-> csrc/fused_train.cu): the train kernel's share of its roofline at the
cell's step, the cohort's clients each with one batch: the least time
(benchmark/roofline.train_bound) over the kernel's time per call, by
CUDA events around replays of a graph of 16 calls on inputs of those
shapes. In %."""

from benchmark import roofline


def read(ctx):
    if not ctx.on_card:
        return None
    import torch
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    s, b = ctx.shapes["cohort"], ctx.shapes["batch"]
    d, h, lat = ctx.dims
    layout = ParamLayout(d, h, lat)
    g = torch.Generator(device=ctx.device).manual_seed(1)
    p = (torch.rand((s, layout.size), generator=g, device=ctx.device)
         - 0.5) * 0.2
    x = torch.randn((s, b, d), generator=g, device=ctx.device)
    m = torch.ones((s, b), device=ctx.device)
    lam = ctx.config["shrink_lambda"] if ctx.config["model_type"] == \
        "hybrid" else 0.0
    ms = roofline.graph_ms(lambda: fused_train_grads(
        p, x, m, layout=layout, shrink_lambda=lam))
    least, _ = roofline.train_bound(b, s, ctx.precision, ctx.dims)
    return 100.0 * least / ms
