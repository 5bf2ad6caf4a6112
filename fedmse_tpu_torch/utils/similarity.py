"""Distribution-similarity scores on the host (port of
fedmse_tpu/utils/similarity.py): float64 numpy and scipy, no sklearn.

  * `similarity_score`: Jensen-Shannon divergence between the exp of a dev
    set's KDE log-scores and a candidate set's own (reference
    src/Utils/utils.py:10-24). The KDE is a Gaussian kernel at sklearn's
    "scott" bandwidth h = n^(-1/(d+4)), not rescaled by the data's spread
    (as sklearn's KernelDensity does), its log density a logsumexp.
  * `kl_divergence` / `js_divergence`: closed-form Gaussian KL and the JS
    over the half mixture (utils.py:26-53).
  * `gmm_kl_variational` / `gmm_js`: the variational bound for Gaussian
    mixtures and its JS, the float64 oracles of the clustering metric.

These are offline analytics. The torch versions the clustering runs on
the card are fedmse_tpu_torch/cluster/similarity.py.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import jensenshannon
from scipy.special import logsumexp


def kde_score_samples(data: np.ndarray, block: int = 1024) -> np.ndarray:
    """log density of each row of `data` under a Gaussian KDE of `data` at
    the scott bandwidth (sklearn's KernelDensity(kernel="gaussian",
    bandwidth="scott").fit(data).score_samples(data)), `block` rows of
    [block, n] distances at a time."""
    data = np.asarray(data, dtype=np.float64)
    n, d = data.shape
    h = n ** (-1.0 / (d + 4))
    norm = np.log(n) + 0.5 * d * np.log(2.0 * np.pi) + d * np.log(h)
    sq = (data * data).sum(1)
    out = np.empty(n)
    for s in range(0, n, block):
        r = data[s:s + block]
        dist = np.maximum(sq[s:s + block, None] - 2.0 * r @ data.T
                          + sq[None, :], 0.0)
        out[s:s + block] = logsumexp(-0.5 * dist / (h * h), axis=1) - norm
    return out


def similarity_score(dev_kde_scores: np.ndarray,
                     dataset_2: np.ndarray) -> float:
    """JS divergence between exp(dev KDE log-scores) and exp of
    dataset_2's KDE log-scores under its own KDE."""
    return float(jensenshannon(np.exp(dev_kde_scores),
                               np.exp(kde_score_samples(dataset_2))))


def _mahalanobis_sq(diff: np.ndarray, cov_inv: np.ndarray) -> float:
    """diffᵀ Σ⁻¹ diff in float64."""
    diff = np.asarray(diff, dtype=np.float64)
    return float(diff.T @ np.asarray(cov_inv, dtype=np.float64) @ diff)


def kl_divergence(p_mean: np.ndarray, p_cov: np.ndarray,
                  q_mean: np.ndarray, q_cov: np.ndarray) -> float:
    """KL(N(p) || N(q)) in closed form."""
    k = p_mean.shape[0]
    q_cov_inv = np.linalg.inv(q_cov)
    tr = np.trace(q_cov_inv @ p_cov)
    maha = _mahalanobis_sq(q_mean - p_mean, q_cov_inv)
    det_ratio = float(np.log(np.linalg.det(q_cov) / np.linalg.det(p_cov)))
    return 0.5 * (tr + maha - k + det_ratio)


def js_divergence(p_mean: np.ndarray, p_cov: np.ndarray,
                  q_mean: np.ndarray, q_cov: np.ndarray) -> float:
    """Gaussian JS divergence over the half mixture N(mean of means, mean
    of covariances)."""
    mix_mean = 0.5 * (p_mean + q_mean)
    mix_cov = 0.5 * (p_cov + q_cov)
    return 0.5 * (kl_divergence(p_mean, p_cov, mix_mean, mix_cov)
                  + kl_divergence(q_mean, q_cov, mix_mean, mix_cov))


def gmm_kl_variational(p_w: np.ndarray, p_means: np.ndarray,
                       p_covs: np.ndarray, q_w: np.ndarray,
                       q_means: np.ndarray, q_covs: np.ndarray) -> float:
    """Variational KL between Gaussian mixtures (Hershey & Olsen 2007,
    eq. 20):

        KL(f||g) ~= Σ_a w_a log( Σ_a' w_a' e^{-KL(f_a||f_a')}
                                / Σ_b  v_b  e^{-KL(f_a||g_b)} ).

    Zero-weight components are dropped (their log would poison the sum)."""
    keep_p, keep_q = p_w > 0.0, q_w > 0.0
    p_w, p_means, p_covs = p_w[keep_p], p_means[keep_p], p_covs[keep_p]
    q_w, q_means, q_covs = q_w[keep_q], q_means[keep_q], q_covs[keep_q]
    kl_ff = np.array([[kl_divergence(p_means[a], p_covs[a],
                                     p_means[b], p_covs[b])
                       for b in range(len(p_w))] for a in range(len(p_w))])
    kl_fg = np.array([[kl_divergence(p_means[a], p_covs[a],
                                     q_means[b], q_covs[b])
                       for b in range(len(q_w))] for a in range(len(p_w))])
    num = np.log(np.sum(p_w[None, :] * np.exp(-kl_ff), axis=1))
    den = np.log(np.sum(q_w[None, :] * np.exp(-kl_fg), axis=1))
    return float(np.sum(p_w * (num - den)))


def gmm_js(p_w: np.ndarray, p_means: np.ndarray, p_covs: np.ndarray,
           q_w: np.ndarray, q_means: np.ndarray, q_covs: np.ndarray) -> float:
    """Mixture JS over the half mixture 0.5 f + 0.5 g, itself a GMM (the
    components of both at half weight)."""
    m_w = np.concatenate([0.5 * p_w, 0.5 * q_w])
    m_means = np.concatenate([p_means, q_means])
    m_covs = np.concatenate([p_covs, q_covs])
    return 0.5 * (gmm_kl_variational(p_w, p_means, p_covs, m_w, m_means,
                                     m_covs)
                  + gmm_kl_variational(q_w, q_means, q_covs, m_w, m_means,
                                       m_covs))
