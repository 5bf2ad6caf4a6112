"""A plain reference of KitNET (Kitsune, NDSS 2018; Kitsune-py `KitNET/`) as
the port trains it, for the CPU tests: the feature map, the forward, the
loss with its gradients by autograd, and the running statistics. It
imports torch, numpy and scipy only, no kernel and no op of the port, and
computes in float32 (float64 for the correlation distances), one model at
a time, without batching over models.

A model of feature map v (k clusters) and hidden ratio beta is one flat
row: for each cluster a in map order, then for the output autoencoder
(over the k RMSEs), W [n, h] (row-major), b [h], c [n], n its inputs and
h = ceil(beta n). Its statistics are lo [k] then hi [k].

  y = sigmoid(u W + b),  o = y W^T + c,  z = sigmoid(o)
  s_a = sqrt(mean_j (x_{v_a, j} - z_j)^2)
  s^ = (s - lo) / (hi - lo + 1e-16), s where hi < lo
  statistic = mean_i (s^_i - z_out, i)^2
  loss = sum over autoencoders of sum_j softplus(o_j) - u_j o_j, the mean
         over a batch's real rows (s^ a constant input of the output)

Departures from Kitsune-py, as the port has them: the inputs are scaled
by each gateway's train min and max before the model (not by running
extremes inside each autoencoder); the map comes from the mean over
gateways of their correlation distances; minibatch Adam in place of
per-instance SGD (the optimizer is not part of this file), each bias entry
its own gradient; no grace periods.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from scipy.cluster.hierarchy import linkage, to_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def feature_map(train_x: Sequence[np.ndarray], max_ae: int = 10
                ) -> Tuple[Tuple[int, ...], ...]:
    """The federation's map from each gateway's train rows [R_g, D]: the
    mean over gateways of 1 - corrcoef (clipped at 0; a constant feature
    correlates with nothing), single linkage on its upper triangle, the
    tree cut as corClust.__breakClust__ cuts it."""
    dists = []
    for x in train_x:
        x = np.asarray(x, np.float64)
        sd = x.std(axis=0)
        cov = np.cov(x, rowvar=False, bias=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = cov / np.outer(sd, sd)
        r[~np.isfinite(r)] = 0.0
        r[np.outer(sd, sd) == 0] = 0.0
        dists.append(np.maximum(1.0 - r, 0.0))
    dist = np.mean(dists, axis=0)
    n = dist.shape[0]
    max_ae = min(max(max_ae, 1), n)
    tree = to_tree(linkage(dist[np.triu_indices(n, 1)], method="single"))

    def cut(node) -> List[Tuple[int, ...]]:
        if node.count <= max_ae:
            return [tuple(node.pre_order())]
        return cut(node.get_left()) + cut(node.get_right())

    return tuple(cut(tree))


def shapes(fmap, beta: float = 0.75) -> List[Tuple[int, int]]:
    """(n, h) of each autoencoder, the ensemble's then the output's."""
    def hidden(n):
        return max(1, math.ceil(beta * n))
    out = [(len(c), hidden(len(c))) for c in fmap]
    return out + [(len(fmap), hidden(len(fmap)))]


def unflatten(row: torch.Tensor, fmap, beta: float = 0.75):
    """[(W, b, c)] of one model's flat row, layout order."""
    out, at = [], 0
    for n, h in shapes(fmap, beta):
        w = row[at:at + n * h].reshape(n, h)
        at += n * h
        b = row[at:at + h]
        at += h
        c = row[at:at + n]
        at += n
        out.append((w, b, c))
    return out


def _softplus(o):
    return torch.clamp(o, min=0.0) + torch.log1p(torch.exp(-torch.abs(o)))


def _autoencoder(w, b, c, u):
    y = torch.sigmoid(u @ w + b)
    o = y @ w.T + c
    return o, torch.sigmoid(o)


def rmses(row, x, fmap, beta: float = 0.75) -> torch.Tensor:
    """[R, k]: each ensemble member's RMSE of rows x [R, D]."""
    parts = unflatten(row, fmap, beta)
    out = []
    for (w, b, c), cluster in zip(parts, fmap):
        u = x[:, list(cluster)]
        _, z = _autoencoder(w, b, c, u)
        out.append(torch.sqrt(((u - z) ** 2).mean(dim=1)))
    return torch.stack(out, dim=1)


def normalize(s, stats):
    k = s.shape[1]
    lo, hi = stats[:k], stats[k:]
    return torch.where(hi >= lo, (s - lo) / (hi - lo + 1e-16), s)


def forward(row, stats, x, fmap, beta: float = 0.75):
    """(statistic [R], loss [R]) of rows x [R, D] under one model."""
    parts = unflatten(row, fmap, beta)
    loss = torch.zeros(x.shape[0], dtype=x.dtype)
    s = []
    for (w, b, c), cluster in zip(parts, fmap):
        u = x[:, list(cluster)]
        o, z = _autoencoder(w, b, c, u)
        s.append(torch.sqrt(((u - z) ** 2).mean(dim=1)))
        loss = loss + (_softplus(o) - u * o).sum(dim=1)
    shat = normalize(torch.stack(s, dim=1), stats).detach()
    o, z = _autoencoder(*parts[-1], shat)
    loss = loss + (_softplus(o) - shat * o).sum(dim=1)
    return ((shat - z) ** 2).mean(dim=1), loss


def updated_stats(row, stats, x, mask, fmap, beta: float = 0.75):
    """The statistics after a train step's update: lo and hi extended by
    the RMSEs of the batch's real rows under the pre-step params."""
    k = len(fmap)
    with torch.no_grad():
        s = rmses(row, x, fmap, beta)[mask > 0]
    if s.shape[0] == 0:
        return stats.clone()
    return torch.cat([torch.minimum(stats[:k], s.min(dim=0).values),
                      torch.maximum(stats[k:], s.max(dim=0).values)])


def train_step(row, stats, x, mask, fmap, beta: float = 0.75):
    """(loss, grads [P], new stats) of one client's batch x [R, D] (mask
    [R]): the statistics first, then the mean loss over the real rows and
    its gradient by autograd."""
    new = updated_stats(row, stats, x, mask, fmap, beta)
    leaf = row.detach().clone().requires_grad_(True)
    _, per_row = forward(leaf, new, x, fmap, beta)
    loss = (per_row * mask).sum() / mask.sum()
    (grads,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grads, new
