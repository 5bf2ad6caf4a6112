"""Masked per-cluster aggregation on flat params (port of
fedmse_tpu/cluster/merge.py).

The single-global merge is `weights @ params` ([N] x [N, P]). Clustered
federation folds membership in as a one-hot [K, N] weight sheet: row k
holds the (MSE- or uniformly) weighted, within-cluster normalized weights
of cluster k's effective cohort, and ONE product [K, N] x [N, P] gives all
K cluster models (f32, TF32 off on the card, as `weighted_mean`). Every
shape follows the arguments, so the fused round's buffers fix them.

A cluster with no effective member this round has `has_update[k] = 0`:
its clients keep their whole state (the chaos broadcast-loss semantics),
and its sheet row stays 0, never 0/0.

Personalization is a layer mask on the same machinery: `shared_mask`
turns the shared top-level modules into a constant [P] bool mask over the
flat layout (models/flat.py: the encoder is W1, b1, W2, b2), and
`personalized_broadcast` takes the cluster merge there and each client's
own post-training params elsewhere.

`cluster_models` is the serving side: the [K, ...] cluster models
gathered into the [N, ...] per-gateway layout an engine routes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.federation.aggregation import (UPDATE_TYPES,
                                                     make_raw_weights_fn,
                                                     weighted_mean)
from fedmse_tpu_torch.models.flat import ParamLayout


def cluster_one_hot(cluster_in: torch.Tensor, k: int) -> torch.Tensor:
    """[K, N] f32 membership sheet of the [N] assignment vector."""
    ids = torch.arange(k, device=cluster_in.device)
    return (cluster_in[None, :] == ids[:, None]).to(torch.float32)


def normalize_sheet(raw: torch.Tensor, cluster_in: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sheet [K, N], weights [N], has_update [K] bool) from per-client raw
    weights: raw masked into its cluster's row and normalized within the
    row. An empty row stays 0 and flags has_update = False; `weights` is
    each client's weight inside its own cluster's merge."""
    sheet = cluster_one_hot(cluster_in, k) * raw[None, :]
    row_sums = sheet.sum(dim=1)
    has_update = row_sums > 0
    sheet = sheet / torch.clamp(row_sums, min=1e-30)[:, None]
    return sheet, sheet.sum(dim=0), has_update


def make_clustered_aggregate_fn(model, update_type: str, k: int) -> Callable:
    """fn(params [N, P], sel_mask [N], dev_x [M, D], cluster_in [N],
    sel_idx=None) -> (cluster_params [K, P], weights [N], has_update [K]).

    The clustered twin of aggregation.make_aggregate_fn: the same mse_avg
    dev scoring (one forward launch over the cohort's models, `sel_idx`
    the compact cohort), normalized per cluster instead of fleet-wide."""
    if update_type not in UPDATE_TYPES:
        raise ValueError(f"unknown update_type {update_type!r}; expected "
                         f"one of {UPDATE_TYPES}")
    raw_weights = make_raw_weights_fn(model, update_type)

    @torch.no_grad()
    def aggregate(params: torch.Tensor, sel_mask: torch.Tensor,
                  dev_x: torch.Tensor, cluster_in: torch.Tensor,
                  sel_idx: Optional[torch.Tensor] = None):
        raw = raw_weights(params, sel_mask, dev_x, sel_idx)
        sheet, weights, has_update = normalize_sheet(raw, cluster_in, k)
        return weighted_mean(params, sheet), weights, has_update

    return aggregate


def gather_cluster_rows(cluster_params: torch.Tensor,
                        cluster_in: torch.Tensor) -> torch.Tensor:
    """[N, P]: row n is its gateway's cluster model."""
    return cluster_params.index_select(0, cluster_in)


def shared_mask(layout: ParamLayout, shared: Sequence[str],
                device=None) -> torch.Tensor:
    """[P] bool: True on the columns of the top-level modules in `shared`
    ('encoder': W1, b1, W2, b2; 'decoder': W3, b3, W4, b4)."""
    modules = sorted({path[0] for path, _, _ in layout.leaves()})
    missing = [m for m in shared if m not in modules]
    if missing:
        raise ValueError(
            f"shared modules {missing} not in the param tree "
            f"(top-level modules: {modules})")
    mask = torch.zeros(layout.size, dtype=torch.bool, device=device)
    for (path, _, _), cols in zip(layout.leaves(), layout.slices()):
        if path[0] in shared:
            mask[cols] = True
    return mask


def personalized_broadcast(agg_stacked: torch.Tensor,
                           local_params: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """[N, P]: the cluster merge on the shared columns (`mask`, from
    `shared_mask`), each client's own params everywhere else."""
    return torch.where(mask, agg_stacked, local_params)


def clustered_incumbent_means(params: torch.Tensor, incumbents: torch.Tensor,
                              cluster_in: torch.Tensor, k: int
                              ) -> torch.Tensor:
    """[N, P] join inheritance: row n is the uniform mean of its cluster's
    incumbents, or the fleet's incumbent mean when its cluster has none
    this round (a joiner inherits a live model whenever anyone is live)."""
    sheet = cluster_one_hot(cluster_in, k) * incumbents[None, :]
    counts = sheet.sum(dim=1)
    sheet = sheet / torch.clamp(counts, min=1.0)[:, None]
    fleet_w = incumbents / torch.clamp(incumbents.sum(), min=1.0)
    rows = gather_cluster_rows(weighted_mean(params, sheet), cluster_in)
    has = (counts > 0).index_select(0, cluster_in)
    return torch.where(has[:, None], rows, weighted_mean(params, fleet_w))


def cluster_models(cluster_params: Any, assignment) -> Any:
    """The [K, ...] cluster models in the [N, ...] per-gateway layout
    (gateway g serves cluster_params[assignment[g]]): a flat [K, P] tensor,
    or a tree of [K, ...] leaves (tensors or numpy, e.g. a JAX cluster
    tree exported with np.asarray)."""
    if isinstance(cluster_params, dict):
        return {key: cluster_models(v, assignment)
                for key, v in cluster_params.items()}
    t = cluster_params if isinstance(cluster_params, torch.Tensor) \
        else torch.from_numpy(np.array(cluster_params))
    idx = torch.as_tensor(np.asarray(assignment, np.int64), device=t.device)
    return t.index_select(0, idx)
