"""Gaussian KL / JS divergences: the clustering assignment metric (port of
fedmse_tpu/cluster/similarity.py), in torch f32 on the tensors' device.

Each function broadcasts over leading axes, so the [G, G] pairwise matrix
is one batch of Cholesky factorizations of the pairs' half-mixture
covariances ([G, G, L, L], L = 7 at the paper's width) rather than a
vmap; `pairwise_js` walks the rows in blocks so a 4,096-gateway fleet
stays a few hundred MB. The covariances carry the caller's eps·I ridge
(cluster/assign.py), so every factorization is of a positive definite
matrix. As in the JAX package, the log-determinant ratio is a difference
of log-determinants (here twice the log of the Cholesky diagonal), which
stays finite where a determinant of a small-eigenvalue latent covariance
would underflow f32; the inverse is the Cholesky inverse and the
Mahalanobis term `ops.distance.quadratic_form`.
"""

from __future__ import annotations

import torch

from fedmse_tpu_torch.ops.distance import ACCUM, quadratic_form

ROW_BLOCK = 256  # rows of the [G, G] matrix per batch of factorizations


def _logdet(chol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def gaussian_kl(p_mean: torch.Tensor, p_cov: torch.Tensor,
                q_mean: torch.Tensor, q_cov: torch.Tensor) -> torch.Tensor:
    """KL(N(p) || N(q)) in closed form, f32; means [..., L], covs
    [..., L, L], leading axes broadcast."""
    p_mean, q_mean = p_mean.to(ACCUM), q_mean.to(ACCUM)
    p_cov, q_cov = p_cov.to(ACCUM), q_cov.to(ACCUM)
    k = p_mean.shape[-1]
    q_chol = torch.linalg.cholesky(q_cov)
    q_inv = torch.cholesky_inverse(q_chol)
    tr = (q_inv * p_cov.transpose(-1, -2)).sum(dim=(-2, -1))
    maha = quadratic_form(q_mean - p_mean, q_inv)
    det_ratio = _logdet(q_chol) - _logdet(torch.linalg.cholesky(p_cov))
    return 0.5 * (tr + maha - k + det_ratio)


def gaussian_js(p_mean: torch.Tensor, p_cov: torch.Tensor,
                q_mean: torch.Tensor, q_cov: torch.Tensor) -> torch.Tensor:
    """Gaussian JS through the half mixture: symmetric, >= 0 up to float
    noise."""
    mix_mean = 0.5 * (p_mean + q_mean)
    mix_cov = 0.5 * (p_cov + q_cov)
    return 0.5 * (gaussian_kl(p_mean, p_cov, mix_mean, mix_cov)
                  + gaussian_kl(q_mean, q_cov, mix_mean, mix_cov))


def js_to_references(means: torch.Tensor, covs: torch.Tensor,
                     ref_means: torch.Tensor, ref_covs: torch.Tensor
                     ) -> torch.Tensor:
    """[G, K] Gaussian JS of each gateway's Gaussian (means [G, L], covs
    [G, L, L]) to K reference Gaussians, in row blocks."""
    out = []
    for s in range(0, means.shape[0], ROW_BLOCK):
        m, c = means[s:s + ROW_BLOCK], covs[s:s + ROW_BLOCK]
        out.append(gaussian_js(m[:, None], c[:, None], ref_means[None],
                               ref_covs[None]))
    if not out:
        return torch.zeros((0, ref_means.shape[0]), device=means.device)
    return torch.cat(out)


def pairwise_js(means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """[G, G] Gaussian-JS matrix over G gateways' latent statistics. It is
    symmetric up to float reduction order; the medoid fit symmetrizes it."""
    return js_to_references(means, covs, means, covs)


def _component_log_terms(w: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """log(w) - kl, with exact-zero weights at -inf (they drop out of the
    logsumexp, as the JAX package's weighted logsumexp drops them)."""
    return torch.where(w > 0, torch.log(w), float("-inf")) - kl


def gmm_kl(p_w, p_means, p_covs, q_w, q_means, q_covs) -> torch.Tensor:
    """Variational KL between Gaussian mixtures (Hershey & Olsen 2007, eq.
    20): weights [A] / [B], means [A, L] / [B, L], covs [A, L, L] /
    [B, L, L]."""
    kl_ff = gaussian_kl(p_means[:, None], p_covs[:, None], p_means[None],
                        p_covs[None])
    kl_fg = gaussian_kl(p_means[:, None], p_covs[:, None], q_means[None],
                        q_covs[None])
    num = torch.logsumexp(_component_log_terms(p_w[None], kl_ff), dim=1)
    den = torch.logsumexp(_component_log_terms(q_w[None], kl_fg), dim=1)
    return torch.sum(p_w.to(ACCUM) * (num - den))


def gmm_js(p_w, p_means, p_covs, q_w, q_means, q_covs) -> torch.Tensor:
    """Mixture JS through the half mixture (itself a GMM: both component
    sets at half weight)."""
    m_w = torch.cat([0.5 * p_w, 0.5 * q_w])
    m_means = torch.cat([p_means, q_means])
    m_covs = torch.cat([p_covs, q_covs])
    return 0.5 * (gmm_kl(p_w, p_means, p_covs, m_w, m_means, m_covs)
                  + gmm_kl(q_w, q_means, q_covs, m_w, m_means, m_covs))


def pairwise_gmm_js(weights: torch.Tensor, means: torch.Tensor,
                    covs: torch.Tensor) -> torch.Tensor:
    """[G, G] variational mixture-JS matrix over G gateways' latent GMMs
    (weights [G, M], means [G, M, L], covs [G, M, L, L]). Every component
    KL the matrix needs is one of the [G·M, G·M] component pairs, computed
    once; row g's mixture with gateway h is then a logsumexp over g's and
    h's components at half weight."""
    g, m, lat = means.shape
    w = weights.to(ACCUM)
    flat_m, flat_c = means.reshape(g * m, lat), covs.reshape(g * m, lat, lat)
    kl = torch.cat([gaussian_kl(flat_m[s:s + ROW_BLOCK, None],
                                flat_c[s:s + ROW_BLOCK, None], flat_m[None],
                                flat_c[None])
                    for s in range(0, g * m, ROW_BLOCK)])
    kl = kl.view(g, m, g, m)                       # [g, a, h, b]
    ids = torch.arange(g, device=means.device)
    own = kl[ids, :, ids, :]                       # [g, a, b]
    self_term = torch.logsumexp(_component_log_terms(w[:, None, :], own),
                                dim=-1)            # [g, a]
    half = _component_log_terms(0.5 * w, torch.zeros_like(w))  # [g, b]
    own_half = (half[:, None, :] - own)[:, :, None, :].expand(g, m, g, m)
    cross_half = half[None, None, :, :] - kl       # [g, a, h, b]
    mix = torch.logsumexp(torch.cat([own_half, cross_half], dim=-1),
                          dim=-1)                  # [g, a, h]
    kl_gm = (w[:, :, None] * (self_term[:, :, None] - mix)).sum(dim=1)
    return 0.5 * (kl_gm + kl_gm.T)
