"""Gateway -> cluster assignment (port of fedmse_tpu/cluster/assign.py):
latent statistics, JS k-medoids, and the `ClusterAssignment` the engine,
the checkpoints and (later) the serving roster carry.

  1. **probe encode**: every gateway's normal-train rows are encoded by ONE
     shared probe model, the client_mask-weighted mean of the current
     params (the elastic joiner's incumbent mean), so the statistics
     reflect the data, not the models' divergence. It is one launch of
     the fused forward kernel: G = 1 model over all N x S rows;
  2. **latent statistics**: each gateway's masked mean and covariance of
     its latents in f32 (divided by the count, not count - 1), covariance
     + eps·I so thin shards stay invertible;
  3. **fit**: the [G, G] Gaussian-JS matrix (cluster/similarity.py, on the
     device) feeds a deterministic k-medoids on the host, in numpy: the
     most central gateway, farthest-point expansion, Lloyd refinement to
     a fixpoint; the 'gmm' metric's per-gateway EM is host numpy too;
  4. **cluster Gaussians**: each cluster's moment-matched pooled Gaussian
     backs the nearest-cluster lookup.

Everything is keyed by absolute gateway id: the statistics take the real
gateways' slice and the probe's padding rows weigh exactly 0, so padding
the client axis cannot move an assignment. The host-side numpy functions
are the JAX module's, line for line.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.cluster.similarity import (js_to_references,
                                                 pairwise_gmm_js, pairwise_js)
from fedmse_tpu_torch.cluster.spec import ClusterSpec
from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.federation.aggregation import weighted_mean
from fedmse_tpu_torch.federation.state import client_mean_weights
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats

# covariance ridge: keeps thin-shard latent covariances invertible for
# the JS quadratic form without visibly moving well-conditioned ones
COV_EPS = 1e-4


def _where(x: Any, device: Optional[DeviceLike]) -> torch.device:
    """`device`, or (None) where a tensor x lies, and the card for anything
    else."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return resolve_device(device)


def _host(x: Any) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _tensor(x: Any, device: Optional[DeviceLike]) -> torch.Tensor:
    """x as an f32 tensor on `device` (None: see _where)."""
    return torch.as_tensor(_host(x)).to(_where(x, device))


def incumbent_mean_params(params: torch.Tensor,
                          member: torch.Tensor) -> torch.Tensor:
    """The shared probe model [P]: the member-weighted mean of params
    [N, P] in f32 (the elastic incumbent mean's rule). `member` is any 0/1
    weighting [N]: client_mask, or member ∧ client_mask under churn."""
    return weighted_mean(params, client_mean_weights(member))


def _probe_latents(layout: ParamLayout, cdt: torch.dtype,
                   probe: torch.Tensor, train_x: torch.Tensor
                   ) -> torch.Tensor:
    """latents [G, S, L] f32 of every gateway's rows (batch-major
    [G, NB, B, D] or flat [G, S, D]) under the one probe model [P]: one
    forward launch, every row routed to model 0."""
    g, d = train_x.shape[0], train_x.shape[-1]
    x = train_x.reshape(g, -1, d)
    s = x.shape[1]
    latent, _, _ = fused_forward_stats(
        layout.tree(probe.reshape(1, -1), cdt),
        x.reshape(g * s, d).to(cdt).contiguous(), None, compute_dtype=cdt)
    return latent.view(g, s, -1)


def make_latent_stats_fn(model):
    """fn(probe [P], train_x, train_m=None) -> (means [G, L], covs
    [G, L, L]) f32 on the probe's device. `train_x` is batch-major
    [G, NB, B, D] (the FederatedData layout) or flat [G, S, D]; `train_m`
    the matching row mask (None: every row)."""
    layout, cdt = ParamLayout.of(model), model.compute_dtype

    @torch.no_grad()
    def stats(probe: torch.Tensor, train_x: torch.Tensor,
              train_m: Optional[torch.Tensor] = None):
        latent = _probe_latents(layout, cdt, probe, train_x)
        g, s, lat = latent.shape
        m = (torch.ones((g, s), device=latent.device) if train_m is None
             else train_m.reshape(g, -1).to(torch.float32))
        cnt = torch.clamp(m.sum(dim=1), min=1.0)
        mean = torch.einsum("gs,gsl->gl", m, latent) / cnt[:, None]
        d = (latent - mean[:, None]) * m[..., None]
        cov = torch.einsum("gsl,gsk->glk", d, d) / cnt[:, None, None]
        eye = torch.eye(lat, device=latent.device)
        return mean, cov + COV_EPS * eye

    return stats


def make_latent_rows_fn(model):
    """fn(probe [P], train_x) -> latents [G, S, L] f32: the 'gmm' metric's
    input (its EM fits the rows themselves; the row mask is applied on the
    host by fit_gateway_gmms)."""
    layout, cdt = ParamLayout.of(model), model.compute_dtype

    @torch.no_grad()
    def rows(probe: torch.Tensor, train_x: torch.Tensor) -> torch.Tensor:
        return _probe_latents(layout, cdt, probe, train_x)

    return rows


def _fit_gmm_rows(x: np.ndarray, components: int, iters: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic fixed-iteration EM over one gateway's latent rows
    [S, L] (f64): quantile blocks along the principal axis as the init,
    then exactly `iters` EM steps. Returns (w [M], mus [M, L], covs
    [M, L, L]); surplus components (fewer rows than components) pad with
    exact-zero weight and identity covariance."""
    x = np.asarray(x, np.float64)
    s, l = x.shape
    mc = max(1, min(components, s))
    mean = x.mean(axis=0)
    d = x - mean
    cov = d.T @ d / s + COV_EPS * np.eye(l)
    _, evecs = np.linalg.eigh(cov)
    order = np.argsort(d @ evecs[:, -1], kind="stable")
    w = np.zeros(components)
    mus = np.zeros((components, l))
    covs = np.tile(np.eye(l), (components, 1, 1))
    for c, block in enumerate(np.array_split(order, mc)):
        xb = x[block]
        w[c] = len(block) / s
        mus[c] = xb.mean(axis=0)
        db = xb - mus[c]
        covs[c] = db.T @ db / max(1, len(block)) + COV_EPS * np.eye(l)
    for _ in range(iters):
        log_r = np.full((s, components), -np.inf)
        for c in range(mc):
            if w[c] <= 0.0:
                continue
            _, logdet = np.linalg.slogdet(covs[c])
            dc = x - mus[c]
            maha = np.einsum("sl,lk,sk->s", dc, np.linalg.inv(covs[c]), dc)
            log_r[:, c] = (np.log(w[c]) - 0.5 *
                           (maha + logdet + l * np.log(2.0 * np.pi)))
        log_r -= log_r.max(axis=1, keepdims=True)
        r = np.exp(log_r)
        r /= r.sum(axis=1, keepdims=True)
        nk = r.sum(axis=0)
        for c in range(mc):
            if nk[c] <= 1e-12:
                w[c] = 0.0
                continue
            w[c] = nk[c] / s
            mus[c] = r[:, c] @ x / nk[c]
            dc = x - mus[c]
            covs[c] = ((r[:, c, None] * dc).T @ dc / nk[c]
                       + COV_EPS * np.eye(l))
    return w, mus, covs


def fit_gateway_gmms(latents: np.ndarray, row_mask: Optional[np.ndarray],
                     components: int = 2, iters: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-gateway GMMs over latents [G, S, L] (host f64): (weights
    [G, M], means [G, M, L], covs [G, M, L, L]); `row_mask` [G, S] drops
    padded rows first; a gateway with no row fits a unit Gaussian."""
    latents = np.asarray(latents, np.float64)
    g = latents.shape[0]
    l = latents.shape[-1]
    w = np.zeros((g, components))
    mus = np.zeros((g, components, l))
    covs = np.tile(np.eye(l), (g, components, 1, 1))
    for i in range(g):
        rows = latents[i]
        if row_mask is not None:
            rows = rows[np.asarray(row_mask[i]) > 0]
        if not len(rows):
            rows = np.zeros((1, l))
        w[i], mus[i], covs[i] = _fit_gmm_rows(rows, components, iters)
    return w, mus, covs


def moment_match_gmms(weights: np.ndarray, means: np.ndarray,
                      covs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each gateway's GMM collapsed to one moment-matched Gaussian (mixture
    mean; within-component covariance + between-component spread)."""
    weights = np.asarray(weights, np.float64)
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    mm_mean = np.einsum("gm,gml->gl", weights, means)
    spread = means - mm_mean[:, None, :]
    mm_cov = (np.einsum("gm,gmlk->glk", weights, covs)
              + np.einsum("gm,gml,gmk->glk", weights, spread, spread))
    return mm_mean.astype(np.float32), mm_cov.astype(np.float32)


def fit_medoids(js: np.ndarray, k: int, max_iter: int = 32
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic k-medoids over a [G, G] divergence matrix,
    symmetrized: (assignment [G] int32, medoids [k'] int64), k' =
    min(k, G). The most central gateway first, then farthest-point; ties go
    to the lowest absolute id; an empty cluster keeps its medoid."""
    g = js.shape[0]
    k = min(k, g)
    d = 0.5 * (js + js.T)
    np.fill_diagonal(d, 0.0)
    medoids = [int(np.argmin(d.sum(axis=1)))]
    while len(medoids) < k:
        dist_to_chosen = d[:, medoids].min(axis=1)
        dist_to_chosen[medoids] = -np.inf
        medoids.append(int(np.argmax(dist_to_chosen)))
    medoids = np.asarray(sorted(medoids), np.int64)
    assignment = np.argmin(d[:, medoids], axis=1).astype(np.int32)
    for _ in range(max_iter):
        new_medoids = medoids.copy()
        for c in range(k):
            members = np.flatnonzero(assignment == c)
            if not len(members):
                continue
            intra = d[np.ix_(members, members)].sum(axis=1)
            new_medoids[c] = int(members[np.argmin(intra)])
        new_assignment = np.argmin(d[:, new_medoids], axis=1).astype(np.int32)
        if (new_medoids == medoids).all() \
                and (new_assignment == assignment).all():
            break
        medoids, assignment = new_medoids, new_assignment
    return assignment, medoids


def cluster_gaussians(means: np.ndarray, covs: np.ndarray,
                      assignment: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each cluster's pooled Gaussian (mixture mean; within-gateway
    covariance + between-gateway spread) and size, host f64; an empty
    cluster reports count 0 and an identity covariance."""
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    latent = means.shape[1]
    cl_means = np.zeros((k, latent))
    cl_covs = np.tile(np.eye(latent), (k, 1, 1))
    counts = np.zeros(k, np.int64)
    for c in range(k):
        members = np.flatnonzero(assignment == c)
        counts[c] = len(members)
        if not len(members):
            continue
        mu = means[members].mean(axis=0)
        spread = means[members] - mu
        cl_means[c] = mu
        cl_covs[c] = (covs[members].mean(axis=0)
                      + np.einsum("gl,gk->lk", spread, spread) / len(members))
    return (cl_means.astype(np.float32), cl_covs.astype(np.float32), counts)


def _js_to_clusters(means, covs, cl_means, cl_covs, counts,
                    device: Optional[DeviceLike]) -> np.ndarray:
    """[G, K] JS of each gateway to each pooled cluster Gaussian, +inf for
    an empty cluster."""
    js = js_to_references(_tensor(means, device), _tensor(covs, device),
                          _tensor(cl_means, device),
                          _tensor(cl_covs, device)).cpu().numpy()
    js[:, np.asarray(counts) == 0] = np.inf
    return js


def nearest_cluster(means, covs, cl_means, cl_covs, counts: np.ndarray,
                    device: Optional[DeviceLike] = None) -> np.ndarray:
    """[G] nearest non-empty cluster of each gateway's latent Gaussian by
    Gaussian JS: the elastic-join target and the churn-composition
    metric."""
    return np.argmin(_js_to_clusters(means, covs, cl_means, cl_covs, counts,
                                     device), axis=1).astype(np.int32)


@dataclasses.dataclass
class ClusterAssignment:
    """The fitted gateway -> cluster map, keyed by absolute gateway id
    (the engine's `cluster_in` buffer, the checkpoints' extra)."""

    k: int
    assignment: np.ndarray          # [n_real] int32, absolute gateway order
    means: np.ndarray               # [n_real, L] gateway latent means
    covs: np.ndarray                # [n_real, L, L] gateway latent covs
    cl_means: np.ndarray            # [k, L] pooled cluster Gaussians
    cl_covs: np.ndarray             # [k, L, L]
    counts: np.ndarray              # [k] gateways per cluster
    fitted_round: int = 0

    def padded(self, n_pad: int) -> np.ndarray:
        """[n_pad] int32 assignment: pad slots carry cluster 0, inert (every
        weight they could touch is masked by client_mask)."""
        out = np.zeros(n_pad, np.int32)
        out[: len(self.assignment)] = self.assignment
        return out

    def consistency(self, device: Optional[DeviceLike] = None) -> float:
        """Fraction of gateways whose nearest pooled cluster Gaussian is
        their own cluster."""
        near = nearest_cluster(self.means, self.covs, self.cl_means,
                               self.cl_covs, self.counts, device=device)
        return float(np.mean(near == self.assignment))

    def to_extra(self) -> Dict:
        """Checkpoint `extra` payload (JSON-stable)."""
        return {"cluster_k": int(self.k),
                "cluster_assignment": self.assignment.tolist(),
                "cluster_fitted_round": int(self.fitted_round)}

    @staticmethod
    def from_arrays(k: int, assignment: np.ndarray, means, covs,
                    fitted_round: int = 0) -> "ClusterAssignment":
        cl_means, cl_covs, counts = cluster_gaussians(
            means, covs, assignment, k)
        return ClusterAssignment(
            k=k, assignment=np.asarray(assignment, np.int32),
            means=np.asarray(means, np.float32),
            covs=np.asarray(covs, np.float32), cl_means=cl_means,
            cl_covs=cl_covs, counts=counts, fitted_round=fitted_round)


def fit_assignments(means, covs, k: int, fitted_round: int = 0,
                    max_iter: int = 32, sample: int = 0,
                    device: Optional[DeviceLike] = None
                    ) -> ClusterAssignment:
    """JS k-medoids over per-gateway latent statistics: the [G, G] matrix
    on `device` (None: where a tensor `means` lies, else the card), the
    medoids on the host. `sample` > 0 with G > sample fits the medoids on a
    deterministic stride subsample of `sample` gateways and assigns every
    gateway to the nearest medoid Gaussian ([G, k] JS)."""
    dev = _where(means, device)
    means, covs = _host(means), _host(covs)
    g = means.shape[0]
    if sample and g > sample:
        idx = np.round(np.linspace(0, g - 1, sample)).astype(np.int64)
        js = pairwise_js(_tensor(means[idx], dev),
                         _tensor(covs[idx], dev)).cpu().numpy()
        _, medoids_s = fit_medoids(js, k, max_iter=max_iter)
        medoids = idx[medoids_s]
        ref = js_to_references(_tensor(means, dev), _tensor(covs, dev),
                               _tensor(means[medoids], dev),
                               _tensor(covs[medoids], dev)).cpu().numpy()
        assignment = np.argmin(ref, axis=1).astype(np.int32)
    else:
        js = pairwise_js(_tensor(means, dev), _tensor(covs, dev)
                         ).cpu().numpy()
        assignment, _ = fit_medoids(js, k, max_iter=max_iter)
    return ClusterAssignment.from_arrays(k, assignment, means, covs,
                                         fitted_round=fitted_round)


def fit_assignments_gmm(weights, mus, covs, k: int, fitted_round: int = 0,
                        max_iter: int = 32, gmm_iters: int = 8,
                        components: int = 2, row_mask=None,
                        device: Optional[DeviceLike] = None
                        ) -> ClusterAssignment:
    """Variational mixture-JS k-medoids over per-gateway latent GMMs: given
    fitted GMM params (weights [G, M], mus [G, M, L], covs [G, M, L, L])
    or raw latents (weights=None, mus=latents [G, S, L], covs=None, with
    `row_mask`). The assignment carries moment-matched single Gaussians."""
    if weights is None:
        weights, mus, covs = fit_gateway_gmms(mus, row_mask,
                                              components=components,
                                              iters=gmm_iters)
    dev = _where(mus, device)
    js = pairwise_gmm_js(_tensor(weights, dev), _tensor(mus, dev),
                         _tensor(covs, dev)).cpu().numpy()
    assignment, _ = fit_medoids(js, k, max_iter=max_iter)
    mm_means, mm_covs = moment_match_gmms(weights, mus, covs)
    return ClusterAssignment.from_arrays(k, assignment, mm_means, mm_covs,
                                         fitted_round=fitted_round)


def refit_with_hysteresis(means, covs, prev_assignment: np.ndarray, k: int,
                          hysteresis: float, fitted_round: int = 0,
                          device: Optional[DeviceLike] = None
                          ) -> ClusterAssignment:
    """Label-stable cadence refit: the pooled Gaussians of the previous
    labels over the fresh statistics (no medoid refit, so labels cannot
    permute), and gateway g moves to its best cluster only when
    js[g, best] < (1 - hysteresis) * js[g, prev]."""
    dev = _where(means, device)
    means, covs = _host(means), _host(covs)
    prev = np.asarray(prev_assignment, np.int32)
    cl_means, cl_covs, counts = cluster_gaussians(means, covs, prev, k)
    js = _js_to_clusters(means, covs, cl_means, cl_covs, counts, dev)
    g = np.arange(len(prev))
    best = np.argmin(js, axis=1)
    move = js[g, best] < (1.0 - hysteresis) * js[g, prev]
    new = np.where(move, best, prev).astype(np.int32)
    return ClusterAssignment.from_arrays(k, new, means, covs,
                                         fitted_round=fitted_round)


def gateway_latent_stats(model, spec: ClusterSpec, params: torch.Tensor,
                         train_x, train_m, client_mask, n_real: int,
                         stats_fn=None):
    """(means [n_real, L], covs [n_real, L, L], gmm) as numpy under
    `spec.metric`; gmm is None for 'js' and the fitted (weights, mus, covs)
    for 'gmm' (means and covs then their moment-matched collapse).
    `stats_fn` is a cached make_latent_stats_fn / make_latent_rows_fn."""
    probe = incumbent_mean_params(params, client_mask)
    if spec.metric == "gmm":
        if stats_fn is None:
            stats_fn = make_latent_rows_fn(model)
        latents = stats_fn(probe, train_x).cpu().numpy()[:n_real]
        mask = None if train_m is None else \
            train_m.reshape(train_m.shape[0], -1).cpu().numpy()[:n_real]
        gmm = fit_gateway_gmms(latents, mask,
                               components=spec.gmm_components)
        means, covs = moment_match_gmms(*gmm)
        return means, covs, gmm
    if stats_fn is None:
        stats_fn = make_latent_stats_fn(model)
    means, covs = stats_fn(probe, train_x, train_m)
    return means.cpu().numpy()[:n_real], covs.cpu().numpy()[:n_real], None


def fit_from_states(model, spec: ClusterSpec, params: torch.Tensor,
                    train_x, train_m, client_mask, n_real: int,
                    fitted_round: int = 0, stats_fn=None,
                    prev_assignment: Optional[np.ndarray] = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> ClusterAssignment:
    """The engine's one-call fit on the params' device: probe -> latent
    statistics -> k-medoids (or, with `prev_assignment` and
    spec.hysteresis > 0, the hysteresis refit). `timings`, when given,
    receives the seconds of the statistics ("encode_s": the probe mean, its
    forward launch and the moments, read back to the host) and of the fit
    ("fit_s": the JS matrix and the medoids)."""
    t0 = time.perf_counter()
    means, covs, gmm = gateway_latent_stats(
        model, spec, params, train_x, train_m, client_mask, n_real,
        stats_fn=stats_fn)
    t1 = time.perf_counter()
    dev = params.device
    if prev_assignment is not None and spec.hysteresis > 0.0:
        out = refit_with_hysteresis(means, covs, prev_assignment, spec.k,
                                    spec.hysteresis,
                                    fitted_round=fitted_round, device=dev)
    elif gmm is not None:
        out = fit_assignments_gmm(*gmm, spec.k, fitted_round=fitted_round,
                                  device=dev)
    else:
        out = fit_assignments(means, covs, spec.k, fitted_round=fitted_round,
                              sample=spec.fit_sample, device=dev)
    if timings is not None:
        timings.update(encode_s=t1 - t0, fit_s=time.perf_counter() - t1)
    return out


def assignment_from_extra(extra: Dict, spec: ClusterSpec,
                          n_real: int) -> Optional[np.ndarray]:
    """The checkpointed assignment vector, validated: None when the
    snapshot predates clustering (the caller fits); a clear error on a K
    change (the states were merged under the recorded clustering)."""
    k = extra.get("cluster_k")
    if k is None:
        return None
    if int(k) != spec.k:
        raise ValueError(
            f"checkpoint was trained with cluster_k={int(k)} but this run "
            f"uses cluster_k={spec.k}; a K change re-tenants every cluster "
            "model — resume with the matching ClusterSpec or start fresh")
    assignment = np.asarray(extra["cluster_assignment"], np.int32)
    if len(assignment) != n_real:
        raise ValueError(
            f"checkpoint assignment covers {len(assignment)} gateways, "
            f"this federation has {n_real}")
    return assignment
