"""A plain PyTorch reference of a federation of KitNET detectors (Kitsune,
NDSS 2018, arXiv:1802.09089; Kitsune-py `KitNET/KitNET.py`, `dA.py`,
`corClust.py`) under FedMSE's round, as `configs/kitnet-fedprox.json`
states it. Like `fedmse.py` it imports nothing of the program: it reads
the benchmark's inputs (the federation's data, the initial parameters,
the seed, the feature map this module computes) and works every round out
again with batched matrix products and numpy. The round (selection,
Adam, early stopping, the election, the merge, verification, evaluation)
is `fedmse.Reference`'s; only the model differs:

* the feature map (`feature_map`): each gateway's Pearson correlation
  distance 1 - r over its train rows (float64, clipped at 0; a constant
  feature correlates with nothing), their mean over the gateways, single
  linkage on its upper triangle (scipy, as corClust.cluster), the
  dendrogram cut as corClust.__breakClust__ cuts it (left, then right,
  until a subtree holds at most m leaves; its pre-order is a cluster);
* a model: one tied-weight sigmoid autoencoder per cluster (n inputs,
  ceil(0.75 n) hidden units), then the output autoencoder over the k
  RMSEs after the running min-max normalisation s^ = (s - lo) / (hi - lo
  + 1e-16) (s itself where hi < lo); one flat row per client, for each
  autoencoder in map order and then the output one: W [n, h] row-major,
  b [h], c [n]; its statistics lo [k] then hi [k];
* the per-row statistic, read wherever the autoencoder reference reads a
  reconstruction MSE (vote, verification, mse_avg's weights, the
  evaluation's scores): mean_i (s^_i - z_out,i)^2;
* local training: per batch, the statistics first take the min and max of
  the real rows' RMSEs under the pre-step params (a client that stopped
  keeps them), then one Adam step on the mean over real rows of the
  summed cross-entropies sum_j softplus(o_j) - u_j o_j of every
  autoencoder (s^ a constant input of the output one), plus FedProx; the
  validation loss the same function without the update; statistics are
  never restored to a best copy;
* the merge: params by the round's weights, statistics the elementwise
  min of lo and max of hi over the clients of non-zero weight; a client
  that loads the broadcast takes both, one that rejects it keeps both of
  its own; the verifier's delta is the sum over the leaves of their
  Frobenius norms, params only.

The backward pass is written out (benchmark/tests hold it to autograd).
Everything runs in float32 on the inputs' device, TF32 off; with
`tf32=True` (the control) every matrix product's operands are rounded to
TF32 first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.fedmse import (B1, B2, EPS, VOTE_BATCH, Reference,
                                        masked_mean, mm, roc_auc)

FeatureMap = Tuple[Tuple[int, ...], ...]


# ---- the feature map ---- #

def correlation_distance(x: torch.Tensor) -> torch.Tensor:
    """[G, D, D]: 1 - r over the rows of x [G, R, D], float64, clipped at
    0; 1 wherever a feature has no variance."""
    x = x.to(torch.float64)
    centred = x - x.mean(dim=1, keepdim=True)
    cov = centred.transpose(1, 2) @ centred
    sd = torch.sqrt(torch.diagonal(cov, dim1=1, dim2=2))
    outer = sd[:, :, None] * sd[:, None, :]
    r = torch.where(outer > 0, cov / torch.where(outer > 0, outer, 1.0), 0.0)
    return torch.clamp(1.0 - r, min=0.0)


def cut_tree(dist: np.ndarray, max_ae: int) -> FeatureMap:
    """corClust.cluster on a [D, D] distance matrix."""
    from scipy.cluster.hierarchy import linkage, to_tree
    n = dist.shape[0]
    max_ae = min(max(int(max_ae), 1), n)
    tree = to_tree(linkage(dist[np.triu_indices(n, 1)], method="single"))

    def cut(node) -> List[Tuple[int, ...]]:
        if node.count <= max_ae:
            return [tuple(int(i) for i in node.pre_order())]
        return cut(node.get_left()) + cut(node.get_right())

    return tuple(cut(tree))


def feature_map(train_x: torch.Tensor, max_ae: int, block: int = 50
                ) -> FeatureMap:
    """The federation's map from every gateway's train rows [N, R, D] (all
    real), `block` gateways at a time."""
    n, _, d = train_x.shape
    total = torch.zeros((d, d), dtype=torch.float64, device=train_x.device)
    for lo in range(0, n, block):
        total += correlation_distance(train_x[lo:lo + block]).sum(dim=0)
    return cut_tree((total / n).cpu().numpy(), max_ae)


# ---- the model ---- #

def shapes(fmap: FeatureMap, beta: float = 0.75) -> List[Tuple[int, int]]:
    """(n, h) of every autoencoder, the ensemble's then the output's."""
    def hidden(n):
        return max(1, int(math.ceil(beta * n)))
    return [(len(c), hidden(len(c))) for c in fmap] + \
        [(len(fmap), hidden(len(fmap)))]


def leaf_shapes(fmap: FeatureMap, beta: float = 0.75):
    out = []
    for n, h in shapes(fmap, beta):
        out += [(n, h), (h,), (n,)]
    return out


def param_count(fmap: FeatureMap, beta: float = 0.75) -> int:
    return sum(n * h + h + n for n, h in shapes(fmap, beta))


def leaves(flat: torch.Tensor, fmap: FeatureMap, beta: float = 0.75):
    """[(W [C, n, h], b [C, h], c [C, n])] of flat rows [C, P] (views)."""
    out, at, c = [], 0, flat.shape[0]
    for n, h in shapes(fmap, beta):
        w = flat[:, at:at + n * h].reshape(c, n, h)
        at += n * h
        b = flat[:, at:at + h]
        at += h
        v = flat[:, at:at + n]
        at += n
        out.append((w, b, v))
    return out


def fresh_stats(n: int, k: int, device) -> torch.Tensor:
    return torch.cat([torch.full((n, k), float("inf"), device=device),
                      torch.full((n, k), float("-inf"), device=device)], 1)


def softplus(o: torch.Tensor) -> torch.Tensor:
    return torch.clamp(o, min=0.0) + torch.log1p(torch.exp(-torch.abs(o)))


def _tied(w, b, c, u, low: bool):
    y = torch.sigmoid(mm(u, w, low) + b[:, None])
    o = mm(y, w.transpose(1, 2), low) + c[:, None]
    return y, o, torch.sigmoid(o)


def normalize(s: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    k = s.shape[-1]
    lo, hi = stats[:, None, :k], stats[:, None, k:]
    return torch.where(hi >= lo, (s - lo) / (hi - lo + 1e-16), s)


def members(flat, x, fmap, beta: float = 0.75, low: bool = False):
    """Each ensemble member over rows x [C, R, D]: [(u, y, o, z)] and the
    RMSEs [C, R, k]."""
    out, s = [], []
    for (w, b, c), cluster in zip(leaves(flat, fmap, beta), fmap):
        u = x[:, :, list(cluster)]
        y, o, z = _tied(w, b, c, u, low)
        out.append((u, y, o, z))
        s.append(torch.sqrt(torch.square(u - z).mean(dim=-1)))
    return out, torch.stack(s, dim=-1)


def rows(flat, stats, x, fmap, beta: float = 0.75, low: bool = False):
    """(statistic [C, R], loss [C, R]) of rows x [C, R, D], client c's
    rows under client c's params and statistics (s^ a constant to the
    output autoencoder)."""
    parts, s = members(flat, x, fmap, beta, low)
    shat = normalize(s, stats).detach()
    _, o, z = _tied(*leaves(flat, fmap, beta)[-1], shat, low)
    loss = sum((softplus(po) - pu * po).sum(dim=-1) for pu, _, po, _ in parts)
    loss = loss + (softplus(o) - shat * o).sum(dim=-1)
    return torch.square(shat - z).mean(dim=-1), loss


def update_stats(stats, s, m, active):
    """lo and hi of stats [C, 2k] extended by RMSEs s [C, R, k] of the real
    rows (m [C, R] > 0), where `active` [C]."""
    k = s.shape[-1]
    real = (m > 0)[:, :, None]
    lo = torch.minimum(stats[:, :k],
                       torch.where(real, s, float("inf")).amin(dim=1))
    hi = torch.maximum(stats[:, k:],
                       torch.where(real, s, float("-inf")).amax(dim=1))
    return torch.where(active[:, None], torch.cat([lo, hi], dim=1), stats)


def loss_and_grads(flat, stats, prev, x, m, fmap, mu: float, active,
                   beta: float = 0.75, low: bool = False):
    """(loss [C], grads [C, P], new stats [C, 2k]) of each client's batch
    x [C, R, D] (row mask m [C, R]): the statistics updated first (where
    active), the mean over the real rows of the summed cross-entropies,
    plus mu sum (p - prev)^2 when mu; the backward written out: with e =
    m (z - u) at an autoencoder's visible units, its hidden errors
    (e W) y (1 - y), dW = u^T dh + e^T y, db and dc their sums."""
    parts, s = members(flat, x, fmap, beta, low)
    stats = update_stats(stats, s, m, active)
    shat = normalize(s, stats)
    lv = leaves(flat, fmap, beta)
    parts.append((shat,) + _tied(*lv[-1], shat, low))
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    den = torch.clamp(m.sum(dim=1), min=1.0)
    mw = (m / den[:, None])[:, :, None]
    loss = torch.zeros_like(den)
    grads = []
    for (w, _, _), (u, y, o, z) in zip(lv, parts):
        loss = loss + ((softplus(o) - u * o) * mw).sum(dim=(1, 2))
        e = mw * (z - u)
        dh = mm(e, w, low) * (y * (1.0 - y))
        grads += [mm(t(u), dh, low) + mm(t(e), y, low), dh.sum(dim=1),
                  e.sum(dim=1)]
    grads = torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=1)
    if mu:
        loss = loss + mu * torch.square(flat - prev).sum(dim=-1)
        grads = grads + (2.0 * mu) * (flat - prev)
    return loss, grads, stats


def merge_stats(stats: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    k = stats.shape[1] // 2
    take = (weights != 0)[:, None]
    return torch.cat([torch.where(take, stats[:, :k], float("inf")).amin(0),
                      torch.where(take, stats[:, k:],
                                  float("-inf")).amax(0)])


class KitnetReference(Reference):
    """`fedmse.Reference`'s federation of KitNET models of feature map
    `fmap` (the module docstring); `params0` [N, P] in this layout."""

    def __init__(self, cfg: Dict, data: Dict[str, torch.Tensor],
                 params0: torch.Tensor, seed: int, fmap: FeatureMap,
                 tf32: bool = False, block: int = 25):
        super().__init__(cfg, data, params0, seed, tf32=tf32, block=block)
        self.fmap = tuple(tuple(c) for c in fmap)
        self.beta = float(cfg.get("kitnet_hidden_ratio", 0.75))
        self.stats = fresh_stats(self.n, len(self.fmap), params0.device)

    def _rows(self, flat, stats, x):
        return rows(flat, stats, x, self.fmap, self.beta, self.tf32)

    # ---- local training ---- #

    def _train(self, sel: Sequence[int]):
        d, cfg = self.data, self.cfg
        idx = torch.as_tensor(sorted(sel), device=self.params.device)
        p = self.params.index_select(0, idx)
        st = self.stats.index_select(0, idx)
        prev = self.prev_global.index_select(0, idx)
        mu, nu = self.mu.index_select(0, idx), self.nu.index_select(0, idx)
        count = self.count.index_select(0, idx)
        txb, tmb = d["train_xb"].index_select(0, idx), \
            d["train_mb"].index_select(0, idx)
        vxb, vmb = d["valid_xb"].index_select(0, idx), \
            d["valid_mb"].index_select(0, idx)
        c, nb = txb.shape[:2]
        epochs, patience, lr = cfg["epochs"], cfg["patience"], cfg["lr_rate"]
        has_b = tmb.sum(dim=2) > 0
        has_v = vmb.sum(dim=2) > 0
        min_v = torch.full((c,), float("inf"), device=p.device)
        worse = torch.zeros(c, dtype=torch.int64, device=p.device)
        tracking = torch.zeros((c, epochs, 3), device=p.device)
        _, mu_prox = self._terms()
        for e in range(epochs):
            active = (worse < patience) | (e == 0)
            if not bool(active.any()):
                break
            loss_sum = torch.zeros(c, device=p.device)
            for b in range(nb):
                loss, grads, st = loss_and_grads(
                    p, st, prev, txb[:, b], tmb[:, b], self.fmap, mu_prox,
                    active, self.beta, self.tf32)
                step = (has_b[:, b] & active)[:, None]
                new_count = count + 1
                new_mu = (1 - B1) * grads + B1 * mu
                new_nu = (1 - B2) * grads * grads + B2 * nu
                cf = new_count.to(torch.float32)[:, None]
                upd = lr * (new_mu / (1 - torch.pow(B1, cf))) / (
                    torch.sqrt(new_nu / (1 - torch.pow(B2, cf))) + EPS)
                p = torch.where(step, p - upd, p)
                mu = torch.where(step, new_mu, mu)
                nu = torch.where(step, new_nu, nu)
                count = torch.where(step[:, 0], new_count, count)
                loss_sum = loss_sum + torch.where(has_b[:, b], loss, 0.0)
            train_loss = loss_sum / torch.clamp(has_b.sum(dim=1), min=1)
            _, per_row = self._rows(p, st, vxb.flatten(1, 2))
            per_batch = masked_mean(per_row.view(c, vxb.shape[1], -1), vmb)
            if mu_prox:
                per_batch = per_batch + mu_prox * torch.square(
                    p - prev).sum(dim=-1)[:, None]
            v_loss = torch.where(has_v, per_batch, 0.0).sum(dim=1) \
                / torch.clamp(has_v.sum(dim=1), min=1)
            improved = (v_loss < min_v) & active
            min_v = torch.where(improved, v_loss, min_v)
            worse = torch.where(active, torch.where(improved, 0, worse + 1),
                                worse)
            row = torch.stack([train_loss, v_loss, torch.ones_like(v_loss)],
                              dim=1)
            tracking[:, e] = torch.where(active[:, None], row, tracking[:, e])
        self.params[idx], self.mu[idx], self.nu[idx] = p, mu, nu
        self.count[idx] = count
        self.stats[idx] = st
        full = torch.full((self.n, epochs, 3), float("nan"),
                          device=p.device)
        full[idx] = tracking
        best = torch.full((self.n,), float("nan"), device=p.device)
        best[idx] = min_v
        return full, best

    # ---- the election, the merge, verification ---- #

    def _vote_scores(self, voter: int) -> torch.Tensor:
        x = self.data["valid_x"][voter].to(torch.float32)
        m = self.data["valid_m"][voter]
        k = m.sum()
        mean = (x * m[:, None]).sum(dim=0) / k
        std = torch.sqrt((torch.square(x - mean) * m[:, None]).sum(dim=0)
                         / (k - 1)) + 1e-8
        xs = (x - mean) / std
        v = x.shape[0]
        nb = -(-v // VOTE_BATCH)
        pad = nb * VOTE_BATCH - v
        mb = torch.nn.functional.pad(m, (0, pad)).view(nb, VOTE_BATCH)
        has = mb.sum(dim=1) > 0
        out = []
        for lo in range(0, self.n, self.block * 8):
            p = self.params[lo:lo + self.block * 8]
            stat, _ = self._rows(p, self.stats[lo:lo + self.block * 8],
                                 xs.expand(p.shape[0], v, -1))
            stat = torch.nn.functional.pad(stat, (0, pad))
            batch = (stat.view(-1, nb, VOTE_BATCH) * mb).sum(dim=2) \
                / torch.clamp(mb.sum(dim=1), min=1)
            out.append(torch.where(has, batch, 0.0).sum(dim=1)
                       / torch.clamp(has.sum(), min=1))
        return torch.cat(out)

    def _merge_weights(self, sel) -> torch.Tensor:
        if self.cfg["update_type"] != "mse_avg":
            return super()._merge_weights(sel)
        w = torch.zeros(self.n, device=self.params.device)
        idx = torch.as_tensor(sel, device=self.params.device)
        dev = self.data["dev_x"].to(torch.float32)
        stats = []
        for lo in range(0, len(sel), self.block):
            part = idx[lo:lo + self.block]
            p = self.params.index_select(0, part)
            stat, _ = self._rows(p, self.stats.index_select(0, part),
                                 dev.expand(p.shape[0], -1, -1))
            stats.append(stat.mean(dim=1))
        raw = 1.0 / torch.cat(stats)
        w[idx] = raw / raw.sum()
        return w

    def _verify_kitnet(self, agg: int, merged: torch.Tensor,
                       merged_stats: torch.Tensor) -> None:
        cfg = self.cfg
        x = self.data["valid_x"][self.n - 1].to(torch.float32)
        m = self.data["valid_m"][self.n - 1]
        stat, _ = self._rows(merged[None], merged_stats[None], x[None])
        perf = 1.0 / (1.0 + masked_mean(stat, m[None])[0])
        delta = sum(torch.sqrt(torch.square(a - b).flatten(1).sum(1))
                    for a, b in zip(
                        [t for leaf in leaves(self.hist, self.fmap, self.beta)
                         for t in leaf],
                        [t for leaf in leaves(merged[None], self.fmap,
                                              self.beta) for t in leaf]))
        first = ~self.hist_seen
        change = torch.where(first, 0.0, perf - self.hist_perf)
        ok = (delta <= cfg["verification_threshold"]) & \
            (change >= -cfg["performance_threshold"])
        is_agg = torch.arange(self.n, device=merged.device) == agg
        attempted = ~is_agg
        accepted = attempted & (first | ok)
        load = accepted | is_agg
        self.params = torch.where(load[:, None], merged[None], self.params)
        self.stats = torch.where(load[:, None], merged_stats[None],
                                 self.stats)
        self.prev_global = torch.where(accepted[:, None], merged[None],
                                       self.prev_global)
        self.hist = torch.where(attempted[:, None], merged[None], self.hist)
        self.hist_perf = torch.where(attempted, perf, self.hist_perf)
        self.hist_seen = self.hist_seen | attempted
        self.rejected = torch.where(
            attempted, torch.where(accepted, 0, self.rejected + 1),
            self.rejected)

    # ---- evaluation ---- #

    def scores(self, params: torch.Tensor, stats: torch.Tensor = None
               ) -> torch.Tensor:
        """The statistic [N, T] (nan_to_num'd) of every client's test rows
        under `params` [N, P] and `stats` [N, 2k] (its own state's by
        default, or a state read back from the program to judge the
        program's scores)."""
        stats = self.stats if stats is None else stats
        params = params.to(self.params.device, torch.float32)
        stats = stats.to(self.params.device, torch.float32)
        out = []
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            x = self.data["test_x"][lo:hi].to(torch.float32)
            stat, _ = self._rows(params[lo:hi], stats[lo:hi], x)
            out.append(torch.nan_to_num(stat))
        return torch.cat(out)

    # ---- rounds ---- #

    def run(self, chunks: Sequence[int], evals: bool = False) -> Dict:
        """`fedmse.Reference.run`, each kept state with its statistics."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            rounds, states, kept = [], [], []
            for i, k in enumerate(chunks):
                draws = torch.rand((k, self.cohort, self.n),
                                   generator=self.draw_gen)
                for r in range(k):
                    rounds.append(self.round(draws[r]))
                states.append({name: getattr(self, name).detach().cpu()
                               .numpy().copy() for name in ("params", "mu")})
                if evals and i > 0:
                    kept.append({"params": states[-1]["params"],
                                 "stats": self.stats.cpu().numpy().copy(),
                                 "scores": self.scores(self.params).cpu()
                                 .numpy()})
            out = {"rounds": rounds, "states": states}
            if evals:
                out["evals"] = kept
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def round(self, draws: torch.Tensor) -> Dict:
        sel = self.select.sample(range(self.n), self.cohort)
        tracking, min_valid = self._train(sel)
        base = self._vote_scores(sel[0])
        agg, scores = self._elect(sel, base, draws)
        weights = torch.zeros(self.n, device=self.params.device)
        if agg >= 0:
            weights = self._merge_weights(sel)
            merged = mm(weights[None, None], self.params[None],
                        self.tf32)[0, 0]
            self._verify_kitnet(agg, merged,
                                merge_stats(self.stats, weights))
            self.agg_count[agg] += 1
        auc = roc_auc(self.scores(self.params), self.data["test_y"])
        host = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
        return {"selected": list(sel), "aggregator": agg,
                "scores": host(scores), "weights": host(weights),
                "rejected": host(self.rejected), "metrics": host(auc),
                "tracking": host(tracking), "min_valid": host(min_valid)}
