"""Local training (fedmse_tpu_torch/federation/{local_training,optim}.py
-> csrc/adam_update.cu): the step update kernel's share of its roofline at
the cell's step, every cohort client stepping, with FedProx where the
configuration trains with it: the least time over the kernel's time per
call, by CUDA events around replays of a graph of 16 calls, each on its
own inputs of those shapes (benchmark/roofline.graph_ms). The least time
is the bytes the update must move over HBM bandwidth: params, gradients
and both Adam moments read (and the FedProx anchors), params and moments
written, f32, plus 16 bytes a client (its count, flags and losses): (7,
or 8 under FedProx) x S x P x 4 + 16 S. In %. None off the card and
where the program has no update kernel."""

from benchmark import roofline


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from fedmse_tpu_torch.ops.adam_update import adam_update
    except ImportError:
        return None
    import torch
    s = ctx.shapes["cohort"]
    p = roofline.param_count(ctx.dims)
    fedprox = ctx.config["update_type"] == "fedprox"
    dev = ctx.device
    g = torch.Generator(device=dev).manual_seed(1)
    step = torch.ones(s, dtype=torch.bool, device=dev)
    loss = torch.rand(s, generator=g, device=dev)
    mu = ctx.config["fedprox_mu"] if fedprox else 0.0

    def inputs():
        params = (torch.rand((s, p), generator=g, device=dev) - 0.5) * 0.2
        return dict(params=params, state=(
            torch.zeros(s, dtype=torch.int32, device=dev),
            torch.zeros((s, p), device=dev), torch.zeros((s, p), device=dev)),
            grads=torch.randn((s, p), generator=g, device=dev) * 1e-2,
            prev=params.clone() if fedprox else None,
            loss_sum=torch.zeros(s, device=dev))

    # one input set a call of the graph: 16 sets outgrow the 50 MB L2 at
    # the 500-gateway cohorts, so each call reads from device memory
    sets = [inputs() for _ in range(roofline.GRAPH_CALLS)]
    calls = [0]

    def call():
        a = sets[calls[0] % len(sets)]
        calls[0] += 1
        adam_update(a["params"], a["state"], a["grads"],
                    ctx.config["lr_rate"], step, active=step, loss=loss,
                    loss_sum=a["loss_sum"], prev=a["prev"], prox_mu=mu)

    ms = roofline.graph_ms(call)
    nbytes = (8 if fedprox else 7) * s * p * 4 + 16 * s
    least = nbytes / roofline.PEAK_BYTES * 1e3
    return 100.0 * least / ms
