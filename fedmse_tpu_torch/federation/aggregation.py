"""The three aggregation rules (port of
fedmse_tpu/federation/aggregation.py).

  * avg, fedprox: the plain mean over the selected cohort (fedprox's
    difference lives in local training);
  * mse_avg: weight_i = 1 / MSE(dev set, recon_i(dev set)) over the
    selected clients, normalized to sum 1. The dev MSEs of the cohort are
    ONE fused forward launch over dev rows x cohort models.

The merged model is `weights @ params` [N] x [N, P] in f32 (TF32 must be
off on the card: the broadcast every client verifies is this product).
`make_raw_weights_fn` is the unnormalized weighting both the single-global
merge and the clustered one (cluster/merge.py) share. On a padded client
axis the dense engines merge the real rows only (`real_rows_merge`), so a
padded merge is the unpadded one's bits. `make_aggregate_for`
selects the merge of a backend: on a sharded client mesh the collective
merges of parallel/collectives.py.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats

UPDATE_TYPES = ("avg", "fedprox", "mse_avg")


def weighted_mean(params: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """sum_n w_n params_n in f32: [N] x [N, P] -> [P], or a [K, N] sheet
    -> [K, P]."""
    if params.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("aggregation on the card needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return weights.to(torch.float32) @ params.to(torch.float32)


def make_raw_weights_fn(model, update_type: str, runs: int = 1) -> Callable:
    """fn(params [N, P], sel_mask [N], dev_x [M, D], sel_idx=None) -> raw
    [N]: sel_mask / dev MSE for mse_avg (one forward launch over the
    cohort's models; `sel_idx` restricts it to the compact cohort, with
    the same result), sel_mask otherwise. The single-global merge and the
    clustered one (cluster/merge.py) normalize it. With `runs` > 1 the
    models are R runs' cohorts in run order, still one launch, and each
    run's dev MSEs are averaged over its own [S, M] slice: a mean's
    summation order on the card depends on how many rows it reduces, so
    a run gets the bits of the run alone. KitNET's models score with their
    running statistics `stats` [N, 2k]."""
    layout = ParamLayout.of(model)
    cdt = model.compute_dtype

    def raw_weights(params: torch.Tensor, sel_mask: torch.Tensor,
                    dev_x: torch.Tensor,
                    sel_idx: Optional[torch.Tensor] = None,
                    stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        if update_type != "mse_avg":
            return sel_mask
        sub = params if sel_idx is None else params.index_select(0, sel_idx)
        if stats is not None and sel_idx is not None:
            stats = stats.index_select(0, sel_idx)
        s, (m, d) = sub.shape[0], dev_x.shape
        _, mse, _ = fused_forward_stats(
            layout.tree(sub, cdt, stats=stats), dev_x.to(cdt).repeat(s, 1),
            client_index(s, m, params.device), compute_dtype=cdt)
        if runs == 1:
            mses = mse.view(s, m).mean(dim=1)
        else:
            mses = torch.cat([part.mean(dim=1) for part in
                              mse.view(runs, s // runs, m).unbind(0)])
        if sel_idx is not None:
            mses = torch.ones_like(sel_mask).index_copy(0, sel_idx, mses)
        return sel_mask / mses

    return raw_weights


def make_runs_aggregate_fn(model, update_type: str, runs: int,
                           n_real: Optional[int] = None) -> Callable:
    """fn(params [R·N, P], sel_mask [R·N], dev_x [M, D], sel_idx=None) ->
    (merged [R, P], weights [R·N]): `make_aggregate_fn` of R federations
    stacked run by run (the batched round), the dev scoring one launch
    over every run's cohort. Each run is normalized and merged on its own
    rows, by the single-global merge's own ops, so run r's merge is the
    bits of the run alone. One [R, R·N] product would weigh the other
    runs' rows by 0, and a diverged run's NaN times 0 is NaN in every
    run. `n_real` < N merges each run's first n_real rows only, as
    `real_rows_merge` does."""
    if update_type not in UPDATE_TYPES:
        raise ValueError(f"unknown update_type {update_type!r}; expected "
                         f"one of {UPDATE_TYPES}")
    raw_weights = make_raw_weights_fn(model, update_type, runs)

    @torch.no_grad()
    def aggregate(params: torch.Tensor, sel_mask: torch.Tensor,
                  dev_x: torch.Tensor,
                  sel_idx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raw = raw_weights(params, sel_mask, dev_x, sel_idx)
        merged, weights = [], []
        for p, r in zip(params.chunk(runs), raw.chunk(runs)):
            n = p.shape[0] if n_real is None else n_real
            w = r[:n] / r[:n].sum()
            merged.append(weighted_mean(p[:n], w))
            weights.append(torch.nn.functional.pad(w, (0, p.shape[0] - n)))
        return torch.stack(merged), torch.cat(weights)

    return aggregate


def make_aggregate_fn(model, update_type: str) -> Callable:
    """fn(params [N, P], sel_mask [N], dev_x [M, D], sel_idx=None,
    stats=None) -> (merged [P], weights [N]). sel_idx restricts mse_avg's
    dev scoring to the cohort (the weights are the same either way);
    `stats` are KitNET's running statistics, which its dev scoring reads
    (the merged statistics are models/kitnet.merge_stats of the
    weights)."""
    if update_type not in UPDATE_TYPES:
        raise ValueError(f"unknown update_type {update_type!r}; expected "
                         f"one of {UPDATE_TYPES}")
    raw_weights = make_raw_weights_fn(model, update_type)

    @torch.no_grad()
    def aggregate(params: torch.Tensor, sel_mask: torch.Tensor,
                  dev_x: torch.Tensor,
                  sel_idx: Optional[torch.Tensor] = None,
                  stats: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raw = raw_weights(params, sel_mask, dev_x, sel_idx, stats=stats)
        weights = raw / raw.sum()
        return weighted_mean(params, weights), weights

    return aggregate


def real_rows_merge(merge: Callable, n_real: int) -> Callable:
    """`merge` (make_aggregate_fn's, or the clustered twin's) over the
    first n_real rows of a padded client axis, its weights [N] padded back
    with zeros. A pad client weighs 0, so the value is the merge's, and
    the bits are the unpadded merge's: a matrix-vector product sums its
    rows in an order that depends on how many there are, on the CPU and
    on the card alike."""
    def merge_real(params: torch.Tensor, sel_mask: torch.Tensor,
                   dev_x: torch.Tensor, *cluster_in: torch.Tensor,
                   sel_idx: Optional[torch.Tensor] = None, **stats):
        # `stats`: the dense merge's running statistics [N, Q], cut alike
        out = merge(params[:n_real], sel_mask[:n_real], dev_x,
                    *(c[:n_real] for c in cluster_in), sel_idx=sel_idx,
                    **{k: v[:n_real] for k, v in stats.items()})
        weights = torch.nn.functional.pad(out[1],
                                          (0, params.shape[0] - n_real))
        return (out[0], weights, *out[2:])

    return merge_real


BACKENDS = ("auto", "einsum", "shard_map", "quantized")


def make_aggregate_for(model, update_type: str, backend: str, mesh=None,
                       quant_hosts: int = 0, quant_block_size: int = 256,
                       cluster_k: int = 0) -> Callable:
    """The merge of an EFFECTIVE backend (the engine resolves 'auto' and
    degrades off a mesh first). Off a sharded mesh 'einsum' is the dense
    merge; on one, 'einsum' and 'shard_map' are the exact collective merge
    (parallel/collectives.py) and 'quantized' the two-level int8 merge.
    `cluster_k` > 1 selects the K-cluster twin: fn(params, sel_mask, dev_x,
    cluster_in, sel_idx=None) -> (cluster_params [K, P], weights,
    has_update [K])."""
    sharded = mesh is not None and mesh.sharded
    if backend not in ("einsum", "shard_map", "quantized"):
        raise ValueError(f"unknown aggregation_backend {backend!r} "
                         "(einsum | shard_map | quantized)")
    if backend != "einsum" and not sharded:
        raise ValueError(f"aggregation_backend={backend!r} needs a mesh "
                         "(the client axis must be sharded)")
    from fedmse_tpu_torch.parallel import collectives as coll
    if cluster_k > 1:
        if not sharded:
            from fedmse_tpu_torch.cluster.merge import \
                make_clustered_aggregate_fn
            return make_clustered_aggregate_fn(model, update_type, cluster_k)
        if backend == "quantized":
            return coll.make_clustered_hierarchical_aggregate(
                model, update_type, mesh, cluster_k, num_groups=quant_hosts,
                block_size=quant_block_size)
        return coll.make_clustered_shardmap_aggregate(model, update_type,
                                                      mesh, cluster_k)
    if not sharded:
        return make_aggregate_fn(model, update_type)
    if backend == "quantized":
        return coll.make_hierarchical_aggregate(
            model, update_type, mesh, num_groups=quant_hosts,
            block_size=quant_block_size)
    return coll.make_shardmap_aggregate(model, update_type, mesh)
