"""KitNET, the detector of Kitsune (Mirsky et al., "Kitsune: An Ensemble of
Autoencoders for Online Network Intrusion Detection", NDSS 2018; the
reference code Kitsune-py `KitNET/`), as a federated model of the port.

  * The feature map: the D features split into k clusters of at most
    `max_ae` (Kitsune's m, 10), by single linkage over the Pearson
    correlation distance 1 - r (clipped at 0; corClust.py). Federated:
    each gateway computes its distance matrix over its own train rows and
    the federation takes their mean (a gateway shares a D x D statistic,
    never rows; Kitsune estimates it on one device's first rows). The
    dendrogram is then cut as `corClust.__breakClust__` cuts it: left
    subtree, then right, until a subtree holds at most `max_ae` leaves,
    whose `pre_order()` is a cluster. The map is fixed for the federation.
  * The model (`Kitnet`): one tied-weight sigmoid autoencoder per cluster
    (n_a inputs, ceil(hidden_ratio n_a) hidden units, hidden_ratio
    Kitsune's beta 0.75) and an output autoencoder over the k RMSEs after
    a running min-max normalisation (models/flat.KitnetLayout;
    csrc/kitnet.cu's header has the equations). The federation reads the
    output autoencoder's mean squared error per row where it reads an
    autoencoder's reconstruction MSE; Kitsune's score is its root.
  * Kitsune's init (dA.py): W ~ U(-1/n, +1/n) for n visible units, zero
    biases; the running statistics start at (lo, hi) = (+inf, -inf).

KitNET trains in f32 on the dense layout only (`check_supported`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.models.flat import KitnetLayout
from fedmse_tpu_torch.utils.profiling import span
from fedmse_tpu_torch.utils.seeding import stream_rng

FeatureMap = Tuple[Tuple[int, ...], ...]


def correlation_distance(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """1 - r of each pair of features, clipped at 0, over the rows of x
    [G, R, D] where m [G, R] > 0, in float64: [G, D, D]. A feature with
    no variance correlates with nothing (distance 1)."""
    x = x.to(torch.float64)
    w = (m > 0).to(torch.float64)[:, :, None]
    count = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    centred = (x - (x * w).sum(dim=1, keepdim=True) / count) * w
    cov = centred.transpose(1, 2) @ centred
    sd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    outer = sd[:, :, None] * sd[:, None, :]
    r = torch.where(outer > 0, cov / torch.where(outer > 0, outer, 1.0), 0.0)
    return torch.clamp(1.0 - r, min=0.0)


def cluster_map(dist: np.ndarray, max_ae: int) -> FeatureMap:
    """Kitsune's corClust.cluster on a distance matrix [D, D]: single
    linkage on its upper triangle, the tree cut by __breakClust__."""
    from scipy.cluster.hierarchy import linkage, to_tree
    n = dist.shape[0]
    max_ae = min(max(int(max_ae), 1), n)
    if n == 1:
        return ((0,),)
    tree = to_tree(linkage(np.asarray(dist, np.float64)[
        np.triu_indices(n, 1)]))

    def cut(node):
        if node.count <= max_ae:
            return [tuple(int(i) for i in node.pre_order())]
        return cut(node.get_left()) + cut(node.get_right())

    return tuple(cut(tree))


def federated_feature_map(train_xb: torch.Tensor, train_mb: torch.Tensor,
                          client_mask: torch.Tensor, max_ae: int,
                          block: int = 64) -> FeatureMap:
    """The federation's feature map from every real gateway's train rows
    (batch-major [N, NB, B, D] with their mask [N, NB, B]): the mean over
    the gateways of client_mask of their correlation distances, computed
    `block` gateways at a time, then `cluster_map`."""
    with span("kitnet.feature_map", 0):
        n, d = train_xb.shape[0], train_xb.shape[-1]
        total = torch.zeros((d, d), dtype=torch.float64,
                            device=train_xb.device)
        real = client_mask > 0
        for lo in range(0, n, block):
            x = train_xb[lo:lo + block]
            x = x.reshape(x.shape[0], -1, d)
            m = train_mb[lo:lo + block].reshape(x.shape[0], -1)
            dist = correlation_distance(x, m)
            total += (dist * real[lo:lo + block, None, None]).sum(dim=0)
        mean = total / torch.clamp(real.sum(), min=1)
        return cluster_map(mean.cpu().numpy(), max_ae)


class Kitnet(nn.Module):
    """KitNET of a fixed feature map (module docstring). The federation
    keeps its parameters as flat rows (`param_layout`) and its running
    statistics beside them; the module holds the layout, not a stack of
    parameters."""

    model_type = "kitnet"

    def __init__(self, feature_map: Sequence[Sequence[int]],
                 hidden_ratio: float = 0.75, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype != torch.float32:
            raise ValueError("KitNET computes in float32 only (precision "
                             "'f32'): bf16 is not supported")
        self.param_layout = KitnetLayout(
            tuple(tuple(int(f) for f in c) for c in feature_map),
            float(hidden_ratio))
        self.input_dim = self.param_layout.dim
        self.compute_dtype = compute_dtype


def fresh_stats(n: int, layout: KitnetLayout,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """[n, 2k] running statistics of models that have seen nothing: lo =
    +inf, hi = -inf (Kitsune's initial norms)."""
    dev = resolve_device(device)
    k = layout.k
    return torch.cat([torch.full((n, k), float("inf"), device=dev),
                      torch.full((n, k), float("-inf"), device=dev)], dim=1)


def init_flat(layout: KitnetLayout, n: int,
              generator: Optional[torch.Generator] = None, *,
              device: DeviceLike = "cuda") -> torch.Tensor:
    """[n, P] f32: Kitsune's init of n models, each W ~ U(-1/n_in, +1/n_in)
    drawn leaf by leaf from `generator` (a CPU generator: every client's
    W of one autoencoder before the next's), zero biases."""
    parts = []
    for (name, leaf), _, shape in layout.leaves():
        size = int(np.prod(shape))
        if leaf == "W":
            bound = 1.0 / shape[0]
            parts.append((torch.rand((n, size), generator=generator) * 2.0
                          - 1.0) * bound)
        else:
            parts.append(torch.zeros((n, size)))
    return torch.cat(parts, dim=1).to(resolve_device(device))


def init_pad_flat(layout: KitnetLayout, ids, key, *,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """The init of pad clients `ids` (absolute ids), each from the keyed
    stream `key` at its id (utils/seeding.stream_rng), as
    models/autoencoder.init_pad_params draws an autoencoder's."""
    rows = []
    for i in ids:
        rng = stream_rng(key, i)
        row = []
        for (_, leaf), _, shape in layout.leaves():
            size = int(np.prod(shape))
            if leaf == "W":
                bound = np.float32(1.0 / shape[0])
                row.append((rng.random(size, dtype=np.float32) * 2 - 1)
                           * bound)
            else:
                row.append(np.zeros(size, np.float32))
        rows.append(np.concatenate(row))
    flat = np.stack(rows) if rows else np.zeros((0, layout.size), np.float32)
    return torch.from_numpy(flat).to(resolve_device(device))


def merge_stats(stats: torch.Tensor, weights: torch.Tensor,
                index: int = 0) -> torch.Tensor:
    """The merged model's statistics [2k]: the elementwise min of lo and
    max of hi over the clients that enter the merge with a non-zero
    weight (weights [N]): what one KitNET would hold after all of their
    streams. In the program span `kitnet.stats_merge@index` (the round)
    while a profiler records. Statistics of width 0 (the autoencoders')
    merge to width 0, with no launch and no span."""
    if not stats.shape[-1]:
        return stats.new_empty(stats.shape[-1:])
    with span("kitnet.stats_merge", index):
        k = stats.shape[1] // 2
        take = (weights != 0)[..., None]
        lo = torch.where(take, stats[:, :k], float("inf")).amin(dim=-2)
        hi = torch.where(take, stats[:, k:], float("-inf")).amax(dim=-2)
        return torch.cat([lo, hi], dim=-1)


def check_supported(cfg, *, batch_runs: bool = False,
                    use_mesh: bool = False, serving: bool = False,
                    resume: bool = False) -> None:
    """Raise on what KitNET does not run: another scaler than min-max,
    the tiered layout, batched runs, a client mesh, serving, the kNN and
    centroid scores, bf16, and resuming from snapshots (whose format
    holds the autoencoder's tree and no running statistics)."""
    refused = []
    if cfg.scaler != "minmax":
        refused.append(f"scaler {cfg.scaler!r} (KitNET reads min-max "
                       "scaled rows: --scaler minmax)")
    if cfg.state_layout == "tiered":
        refused.append("the tiered state layout")
    if batch_runs:
        refused.append("--batch-runs")
    if use_mesh:
        refused.append("--use-mesh")
    if serving:
        refused.append("serving (--serve, --serve-net, --flywheel)")
    if cfg.score_kind not in ("auto", "mse"):
        refused.append(f"score_kind {cfg.score_kind!r} (KitNET scores by "
                       "its output autoencoder: 'auto' or 'mse')")
    if cfg.precision != "f32":
        refused.append(f"precision {cfg.precision!r} (f32 only)")
    if resume:
        refused.append("--resume-dir")
    if refused:
        raise ValueError("model_type 'kitnet' does not support "
                         + "; ".join(refused))
