"""Clustered and personalized federation (port of fedmse_tpu/cluster/).

K cluster-level global models instead of one: gateways are grouped by the
Gaussian JS of their latent statistics (assign.py, similarity.py), and
membership folds into the fused round as a [K, N] weight sheet
(merge.py, federation/fused.py); personalization keeps each gateway's
decoder local with a [P] layer mask. `ClusterSpec(k=1)` without
personalization builds nothing: the round is the single-global one."""

from fedmse_tpu_torch.cluster.assign import (ClusterAssignment,
                                             assignment_from_extra,
                                             cluster_gaussians,
                                             fit_assignments,
                                             fit_assignments_gmm,
                                             fit_from_states,
                                             fit_gateway_gmms, fit_medoids,
                                             gateway_latent_stats,
                                             incumbent_mean_params,
                                             make_latent_rows_fn,
                                             make_latent_stats_fn,
                                             moment_match_gmms,
                                             nearest_cluster,
                                             refit_with_hysteresis)
from fedmse_tpu_torch.cluster.merge import (cluster_models, cluster_one_hot,
                                            clustered_incumbent_means,
                                            gather_cluster_rows,
                                            make_clustered_aggregate_fn,
                                            normalize_sheet,
                                            personalized_broadcast,
                                            shared_mask)
from fedmse_tpu_torch.cluster.similarity import (gaussian_js, gaussian_kl,
                                                 gmm_js, gmm_kl,
                                                 js_to_references,
                                                 pairwise_gmm_js,
                                                 pairwise_js)
from fedmse_tpu_torch.cluster.spec import ClusterSpec

__all__ = [
    "ClusterAssignment", "ClusterSpec", "assignment_from_extra",
    "cluster_gaussians", "cluster_models", "cluster_one_hot",
    "clustered_incumbent_means", "fit_assignments", "fit_assignments_gmm",
    "fit_from_states", "fit_gateway_gmms", "fit_medoids",
    "gather_cluster_rows", "gateway_latent_stats", "gaussian_js",
    "gaussian_kl", "gmm_js", "gmm_kl", "incumbent_mean_params",
    "js_to_references", "make_clustered_aggregate_fn", "make_latent_rows_fn",
    "make_latent_stats_fn", "moment_match_gmms", "nearest_cluster",
    "normalize_sheet", "pairwise_gmm_js", "pairwise_js",
    "personalized_broadcast", "refit_with_hysteresis", "shared_mask",
]
