"""The merge with its communication written out (port of
fedmse_tpu/parallel/collectives.py).

Every function here runs on each rank of a `ClientMesh` with that rank's
block of the client axis: params [n, P], the selection mask [n], the
cluster assignment [n], where n = N / W. What crosses ranks is one
all-gather per step, and every sum over the gathered [W, ...] stack runs in
rank order on the rank's device (`rank_sum`): every rank holds the same
bits, under NCCL or gloo alike. (An all-reduce would let the backend
associate the sum, and two backends associate differently.)

  * `make_shardmap_aggregate`: each rank's raw weights (mse_avg: one
    forward launch over its own models' dev MSEs) are gathered to the
    fleet's [N], normalized there exactly as the dense merge normalizes
    them, and each rank's f32 partial w_local @ params_local is gathered
    and summed. On a sharded mesh the 'einsum' backend runs this same
    exact program (the JAX package's auto-partitioned einsum lowers to
    the same partial sums);
  * `make_hierarchical_aggregate`: the two-level int8 merge. The partials
    are summed exactly within each host group; each rank of a group then
    owns a lane, a block-aligned slice of the group's sum, quantizes it
    (parallel/quantize.py), gathers its lane peers' codes across groups,
    dequantizes and sums them in f32, and the group gathers its lanes'
    slices back. With one group it is `make_shardmap_aggregate` exactly;
  * the clustered twins fold the [K, N] one-hot sheet in: the fleet's raw
    weights and assignment are gathered once, the sheet normalized
    globally (cluster rows' weights stay exact f32), and one [K, P]
    partial per rank is exchanged for all K merges. K = 1 wraps the flat
    merge itself;
  * `make_shardmap_divergence` and `sharded_weighted_mean`: the chaos
    axis's mean model and the elastic incumbent mean, as gathered
    partials.

Every merge reports its wire profile to `costmodel.seam` as it runs.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from fedmse_tpu_torch.cluster.merge import cluster_one_hot, normalize_sheet
from fedmse_tpu_torch.federation.aggregation import (UPDATE_TYPES,
                                                     make_raw_weights_fn,
                                                     weighted_mean)
from fedmse_tpu_torch.federation.state import client_mean_weights
from fedmse_tpu_torch.parallel.mesh import ClientMesh
from fedmse_tpu_torch.parallel.quantize import (dequantize_sum_blocks,
                                                quantize_blocks)


def rank_sum(stack: torch.Tensor) -> torch.Tensor:
    """The sum over a gathered stack's leading axis, in rank order."""
    total = stack[0]
    for j in range(1, stack.shape[0]):
        total = total + stack[j]
    return total


def host_groups(mesh: ClientMesh, num_groups: int = 0) -> List[List[int]]:
    """The ranks cut into host groups: `num_groups` 0 is the real topology
    (one group per host, by the hostnames the mesh gathered), > 0 that
    many contiguous equal groups (groups play hosts). Groups must be
    equal."""
    n = mesh.world_size
    if num_groups <= 0:
        by_host: dict = {}
        for r, h in enumerate(mesh.hosts):
            by_host.setdefault(h, []).append(r)
        groups = sorted((sorted(v) for v in by_host.values()),
                        key=lambda g: g[0])
    else:
        if n % num_groups:
            raise ValueError(
                f"num_groups {num_groups} must divide the mesh size {n}")
        per = n // num_groups
        groups = [list(range(g * per, (g + 1) * per))
                  for g in range(num_groups)]
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"host groups must be equal-sized, got sizes "
                         f"{sorted(sizes)} (ranks unevenly spread across "
                         f"hosts)")
    return groups


def _note_merge(backend: str, p: int, *, n_devices: int, k: int = 1,
                n_groups: int = 0, per_group: int = 0,
                block_size: int = 0) -> None:
    from fedmse_tpu_torch.parallel import costmodel
    costmodel.seam.note_merge(backend, costmodel.merge_profile(
        backend=backend, elem_counts=[p], k=k, n_devices=n_devices,
        n_groups=n_groups, per_group=per_group, block_size=block_size))


def sharded_weighted_mean(mesh: ClientMesh, params: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """sum_n w_n params_n over the whole fleet, from this rank's block:
    params [n, P] with its weights [n] (or a [K, n] sheet) -> [P] ([K, P]),
    the same bits on every rank."""
    return rank_sum(mesh.all_gather(weighted_mean(params, weights)))


def make_quantized_exchange(mesh: ClientMesh, num_groups: int,
                            block_size: int) -> Callable:
    """fn(part [K, E] f32, this rank's partial) -> [K, E] f32 fleet sum: an
    exact sum within the host group, the lane-sliced int8 exchange across
    groups (dequantize, then sum in f32, in group order), the group's
    slices gathered back. With one group: the exact sum alone."""
    intra = host_groups(mesh, num_groups)
    n_groups, per = len(intra), len(intra[0])
    inter = [[g[lane] for g in intra] for lane in range(per)]
    intra_groups = mesh.subgroups(intra)
    inter_groups = mesh.subgroups(inter)
    mine = next(i for i, g in enumerate(intra) if mesh.rank in g)
    lane = intra[mine].index(mesh.rank)
    g_intra, g_inter = intra_groups[mine], inter_groups[lane]

    def exchange(part: torch.Tensor) -> torch.Tensor:
        part = part.to(torch.float32)
        host_sum = rank_sum(mesh.all_gather(part, g_intra))
        if n_groups == 1:
            return host_sum
        k, e = host_sum.shape
        nb = -(-e // block_size)
        m = -(-nb // per)
        nb_pad = m * per
        rows = torch.nn.functional.pad(host_sum,
                                       (0, nb_pad * block_size - e))
        blocks = rows.reshape(k, nb_pad, block_size)
        sl = blocks[:, lane * m:(lane + 1) * m]
        q, scales = quantize_blocks(sl)  # [k, m, B] int8, [k, m] f32
        q_stack = mesh.all_gather(q, g_inter)
        s_stack = mesh.all_gather(scales, g_inter)
        sl_sum = dequantize_sum_blocks(q_stack, s_stack)  # [k, m, B]
        full = mesh.all_gather(sl_sum, g_intra)  # [per, k, m, B]
        full = full.permute(1, 0, 2, 3).reshape(k, nb_pad * block_size)
        return full[:, :e]

    return exchange


def _check(update_type: str) -> None:
    if update_type not in UPDATE_TYPES:
        raise ValueError(f"unknown update_type {update_type!r}; expected "
                         f"one of {UPDATE_TYPES}")


def _global_weights(mesh: ClientMesh, raw: torch.Tensor) -> torch.Tensor:
    """This rank's normalized weights [n]: the fleet's raw weights gathered
    and normalized by the dense merge's own ops."""
    raw_all = mesh.all_gather(raw).reshape(-1)
    lo, hi = mesh.block(raw_all.shape[0])
    return (raw_all / raw_all.sum())[lo:hi]


def _flat_aggregate(model, update_type: str, mesh: ClientMesh,
                    reduce: Callable, backend: str, **note) -> Callable:
    _check(update_type)
    raw_weights = make_raw_weights_fn(model, update_type)

    @torch.no_grad()
    def aggregate(params: torch.Tensor, sel_mask: torch.Tensor,
                  dev_x: torch.Tensor, sel_idx=None, stats=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        del sel_idx  # each rank scores its own block: no cross-rank gather
        _note_merge(backend, params.shape[1], n_devices=mesh.world_size,
                    **note)
        w = _global_weights(mesh, raw_weights(params, sel_mask, dev_x,
                                              stats=stats))
        merged = reduce(weighted_mean(params, w)[None])[0]
        return merged.to(params.dtype), w

    return aggregate


def make_shardmap_aggregate(model, update_type: str, mesh: ClientMesh
                            ) -> Callable:
    """fn(params [n, P], sel_mask [n], dev_x [M, D], sel_idx=None) ->
    (merged [P], weights [n]): the exact merge of the fleet from this
    rank's block (module docstring)."""
    return _flat_aggregate(model, update_type, mesh,
                           lambda part: rank_sum(mesh.all_gather(part)),
                           "shard_map")


def make_hierarchical_aggregate(model, update_type: str, mesh: ClientMesh,
                                num_groups: int = 0, block_size: int = 256
                                ) -> Callable:
    """The two-level int8 merge; same signature as
    `make_shardmap_aggregate`, and the same weights (exact f32: only the
    params' partials are coded, only across groups)."""
    intra = host_groups(mesh, num_groups)
    exchange = make_quantized_exchange(mesh, num_groups, block_size)
    return _flat_aggregate(model, update_type, mesh, exchange, "quantized",
                           n_groups=len(intra), per_group=len(intra[0]),
                           block_size=block_size)


def _degenerate_clustered(base: Callable) -> Callable:
    """The K = 1 clustered merge as the flat one: the assignment is dead,
    the merged model gains a leading [1] row, has_update is 'anyone
    selected'."""

    @torch.no_grad()
    def aggregate(params, sel_mask, dev_x, cluster_in, sel_idx=None):
        del cluster_in, sel_idx
        merged, w = base(params, sel_mask, dev_x)
        return merged[None], w, (sel_mask.sum() > 0)[None]

    return aggregate


def _clustered_aggregate(model, update_type: str, mesh: ClientMesh, k: int,
                         reduce: Callable, backend: str, **note) -> Callable:
    _check(update_type)
    raw_weights = make_raw_weights_fn(model, update_type)

    @torch.no_grad()
    def aggregate(params, sel_mask, dev_x, cluster_in, sel_idx=None):
        del sel_idx
        _note_merge(backend, params.shape[1], n_devices=mesh.world_size,
                    k=k, **note)
        raw = raw_weights(params, sel_mask, dev_x)
        both = mesh.all_gather(torch.stack(
            [raw.to(torch.float32), cluster_in.to(torch.float32)]))
        raw_all = both[:, 0].reshape(-1)
        cl_all = both[:, 1].reshape(-1).to(torch.int64)
        sheet, weights, has_update = normalize_sheet(raw_all, cl_all, k)
        lo, hi = mesh.block(raw_all.shape[0])
        merged = reduce(weighted_mean(params, sheet[:, lo:hi]))
        return merged.to(params.dtype), weights[lo:hi], has_update

    return aggregate


def make_clustered_shardmap_aggregate(model, update_type: str,
                                      mesh: ClientMesh, k: int) -> Callable:
    """fn(params [n, P], sel_mask [n], dev_x, cluster_in [n], sel_idx=None)
    -> (cluster_params [K, P], weights [n], has_update [K])."""
    if k == 1:
        return _degenerate_clustered(
            make_shardmap_aggregate(model, update_type, mesh))
    return _clustered_aggregate(
        model, update_type, mesh, k,
        lambda part: rank_sum(mesh.all_gather(part)), "shard_map")


def make_clustered_hierarchical_aggregate(model, update_type: str,
                                          mesh: ClientMesh, k: int,
                                          num_groups: int = 0,
                                          block_size: int = 256
                                          ) -> Callable:
    """The K-cluster int8 merge: each cluster row is coded on its own (a
    [K, nb] scale sheet); K = 1 is `make_hierarchical_aggregate`."""
    if k == 1:
        return _degenerate_clustered(make_hierarchical_aggregate(
            model, update_type, mesh, num_groups, block_size))
    intra = host_groups(mesh, num_groups)
    return _clustered_aggregate(
        model, update_type, mesh, k,
        make_quantized_exchange(mesh, num_groups, block_size), "quantized",
        n_groups=len(intra), per_group=len(intra[0]), block_size=block_size)


def make_shardmap_divergence(mesh: ClientMesh) -> Callable:
    """fn(params [n, P], client_mask [n]) -> [n]: each client's L2 distance
    to the fleet's client_mask-weighted mean model (federation/state.py
    tree_client_divergence), the mean from gathered partials."""

    def divergence(params: torch.Tensor, client_mask: torch.Tensor
                   ) -> torch.Tensor:
        mask_all = mesh.all_gather(client_mask).reshape(-1)
        lo, hi = mesh.block(mask_all.shape[0])
        w = client_mean_weights(mask_all)[lo:hi]
        mean = sharded_weighted_mean(mesh, params, w)
        d = params.to(torch.float32) - mean
        return torch.sqrt((d * d).sum(dim=1))

    return divergence


def sharded_clustered_incumbent_means(mesh: ClientMesh, params: torch.Tensor,
                                      incumbents_all: torch.Tensor,
                                      cluster_all: torch.Tensor, k: int
                                      ) -> torch.Tensor:
    """cluster.merge.clustered_incumbent_means from this rank's block:
    `incumbents_all` and `cluster_all` are the fleet's [N]; returns this
    rank's rows [n, P]."""
    lo, hi = mesh.block(incumbents_all.shape[0])
    sheet = cluster_one_hot(cluster_all, k) * incumbents_all[None, :]
    counts = sheet.sum(dim=1)
    sheet = sheet / torch.clamp(counts, min=1.0)[:, None]
    fleet_w = incumbents_all / torch.clamp(incumbents_all.sum(), min=1.0)
    means = sharded_weighted_mean(mesh, params, sheet[:, lo:hi])
    fleet = sharded_weighted_mean(mesh, params, fleet_w[lo:hi])
    mine = cluster_all[lo:hi]
    rows = means.index_select(0, mine)
    has = (counts > 0).index_select(0, mine)
    return torch.where(has[:, None], rows, fleet)
