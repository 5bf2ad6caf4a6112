"""The port's clustered and personalized federation (fedmse_tpu_torch/cluster/
and the cluster hooks of federation/{voting,verification,fused,rounds,
pipeline}.py and main.py) against the JAX package's, at width 16 / 8 / 3:

  * the spec: validation messages, `is_null` and `signature()` equal;
  * the metric: Gaussian KL / JS, the [G, G] and [G, K] matrices and the
    mixture JS within 1e-5 of the JAX values, scale-normalized (max |err|
    over max |value|); `quadratic_form` within 1e-6 relative;
  * the latent statistics and rows from one probe within 1e-5 of
    `make_latent_stats_fn` / `make_latent_rows_fn`;
  * the host fit (medoids, GMM EM, moment matching, pooled Gaussians,
    hysteresis) the JAX functions' bits, and the assignments equal on the
    typed fleet (types 8.0 apart), dense and subsampled, 'js' and 'gmm';
  * padding invariance through `pad_federated_data` and
    `stack_clients(pad_clients_to=)`: the same assignment, bit for bit;
  * the clustered aggregate (cluster params, weights, has_update, an
    empty cluster, the compact cohort), `personalized_broadcast` and
    `clustered_incumbent_means` within 1e-5 scale-normalized;
  * the cluster-scoped election, against the JAX `_elect_on_device`;
  * clustered fused rounds (K = 2, K = 4, personalized, K = 1
    personalized, an attack composed in) against the JAX fused engine from
    one init and one assignment: states within 1e-5 scale-normalized, the
    same aggregators and verification rows;
  * K = 1 without personalization bit-equal to no spec, with the same
    bodies; an empty cluster's clients untouched; the elastic join from
    the nearest cluster (the joiner from a cluster of at least two);
  * checkpoints in both directions with the reference's keys, the K-change
    error, and a killed clustered run resumed bit for bit;
  * the pipelined refit equal to the serial one (refit every round,
    chunks of 2), and the CLI end to end on the CPU.
"""

import glob
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.checkpointing import CheckpointManager as JaxManager
from fedmse_tpu.cluster import ClusterSpec as JaxSpec
from fedmse_tpu.cluster import assign as jax_assign
from fedmse_tpu.cluster import merge as jax_merge
from fedmse_tpu.cluster import similarity as jax_sim
from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_typed_clients as jax_typed
from fedmse_tpu.federation import AttackSpec as JaxAttackSpec
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec
from fedmse_tpu.federation import RoundEngine as JaxEngine
from fedmse_tpu.federation import make_poison_fn as jax_make_poison_fn
from fedmse_tpu.federation.elastic import MembershipMasks as JaxMasks
from fedmse_tpu.federation.fused import _elect_on_device as jax_elect
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.ops.distance import quadratic_form as jax_quadratic_form
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch import cluster as C
from fedmse_tpu_torch.checkpointing import CheckpointManager
from fedmse_tpu_torch.cluster import ClusterSpec
from fedmse_tpu_torch.config import (CompatConfig, DatasetConfig,
                                     ExperimentConfig)
from fedmse_tpu_torch.data import (pad_federated_data, stack_clients,
                                   synthetic_typed_clients)
from fedmse_tpu_torch.federation import (RoundEngine,
                                         client_states_from_numpy,
                                         run_pipelined_schedule)
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.elastic import ElasticSpec, MembershipMasks
from fedmse_tpu_torch.federation.voting import elect_on_device
from fedmse_tpu_torch.main import run_combination
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.distance import quadratic_form
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import assert_same_round, assert_same_states

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N = 8
BASE = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=N,
            epochs=2)
FLEET = dict(n_clients=N, types=2, dim=16, n_normal=240, n_abnormal=120,
             seed=0)
TAG = "hybrid_mse_avg_run0"


def flat(tree) -> torch.Tensor:
    """A JAX [G, ...] param tree as the port's flat [G, P] f32."""
    return LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)), tree))


def scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return max(scaled_err(got[:, sl].numpy(), want[:, sl].numpy())
               for sl in LAYOUT.slices())


def rand_gaussians(rng, g, lat):
    means = rng.normal(size=(g, lat)).astype(np.float32)
    q = rng.normal(size=(g, lat, lat))
    covs = (np.einsum("gij,gkj->gik", q, q) / lat
            + 0.1 * np.eye(lat)).astype(np.float32)
    return means, covs


def typed_stats(types=2, n=N, spread=8.0, seed=0):
    """Per-gateway Gaussians of `types` well-separated types."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, size=(types, 3))
    means = (centers[np.arange(n) % types]
             + rng.normal(0, 0.3, size=(n, 3))).astype(np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)) * 0.5
    return means, covs


def port_cfg(**kw):
    return ExperimentConfig(**{**BASE, **kw},
                            compat=CompatConfig(vote_tie_break=False))


def jax_cfg(**kw):
    return JaxConfig(**{**BASE, **kw}, compat=JaxCompat(vote_tie_break=False))


def fleet(pad_to=None, **kw):
    clients = synthetic_typed_clients(**{**FLEET, **kw})
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return clients, dev_x, stack_clients(clients, dev_x, 12,
                                         pad_clients_to=pad_to, device="cpu")


def port_engine(cfg=None, data=None, states=None, update_type="mse_avg",
                **kw):
    cfg = cfg or port_cfg()
    return RoundEngine(
        make_model("hybrid", *DIMS, cfg.shrink_lambda, device="cpu"), cfg,
        data if data is not None else fleet()[2], n_real=N,
        rngs=ExperimentRngs(run=0), model_type="hybrid",
        update_type=update_type, states=states, fused=True, **kw)


def pair(spec_kw=None, assignment=None, update_type="mse_avg",
         fleet_kw=None, attack=None, elastic=None, elastic_masks=None,
         **cfg_kw):
    """(JAX engine, port engine) from one init, data and assignment."""
    fleet_kw = fleet_kw or {}
    jclients = jax_typed(**{**FLEET, **fleet_kw})
    clients, dev_x, data = fleet(**fleet_kw)
    jhooks, thooks = {}, {}
    if spec_kw is not None:
        jhooks["cluster"] = JaxSpec(**spec_kw)
        thooks["cluster"] = ClusterSpec(**spec_kw)
    if assignment is not None:
        jhooks["cluster_assignment"] = thooks["cluster_assignment"] = \
            np.asarray(assignment, np.int32)
    if attack is not None:
        jhooks["poison_fn"] = jax_make_poison_fn(JaxAttackSpec(**attack))
        thooks["poison_fn"] = make_poison_fn(AttackSpec(**attack))
    if elastic is not None:
        jhooks["elastic"] = JaxElasticSpec(**elastic)
        thooks["elastic"] = ElasticSpec(**elastic)
        jhooks["elastic_masks"] = JaxMasks(*map(jnp.asarray, elastic_masks))
        thooks["elastic_masks"] = MembershipMasks(*elastic_masks)
    jcfg = jax_cfg(**cfg_kw)
    jeng = JaxEngine(jax_make_model("hybrid", *DIMS, jcfg.shrink_lambda),
                     jcfg, jax_stack(jclients, dev_x, 12), n_real=N,
                     rngs=JaxRngs(run=0), model_type="hybrid",
                     update_type=update_type, fused=True, **jhooks)
    init = client_states_from_numpy(jax.tree.map(np.array, jeng.states),
                                    LAYOUT, device="cpu")
    teng = port_engine(port_cfg(**cfg_kw), data, init, update_type, **thooks)
    return jeng, teng


def assert_engines_agree(jeng, teng, jres, tres, tol=1e-5):
    for want, got in zip(jres, tres):
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        if want.agg_weights is None:
            assert got.agg_weights is None
        else:
            assert scaled_err(got.agg_weights[:N],
                              np.asarray(want.agg_weights)[:N]) <= tol
    for name in ("params", "prev_global", "hist_params"):
        assert leaf_err(getattr(teng.states, name),
                        flat(getattr(jeng.states, name))) <= tol, name
    np.testing.assert_array_equal(teng.states.rejected.numpy(),
                                  np.asarray(jeng.states.rejected))


# ------------------------------------------------------------- the spec ----

@pytest.mark.parametrize("kw", [
    dict(k=0), dict(fit_sample=-1), dict(refit_every=-2),
    dict(metric="kde"), dict(hysteresis=1.0), dict(hysteresis=-0.1),
    dict(gmm_components=0), dict(personalize=True, shared_modules=())])
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        ClusterSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, dict(k=4), dict(k=1, personalize=True), dict(k=3, refit_every=2),
    dict(k=2, metric="gmm", gmm_components=3), dict(k=2, hysteresis=0.25),
    dict(k=5, fit_sample=100), dict(k=2, shared_modules=("decoder",),
                                    personalize=True)])
def test_signature_and_null_match_jax(kw):
    assert ClusterSpec(**kw).signature() == JaxSpec(**kw).signature()
    assert ClusterSpec(**kw).is_null == JaxSpec(**kw).is_null


# ----------------------------------------------------------- the metric ----

def test_kl_js_and_pairwise_matrices_match_jax():
    rng = np.random.default_rng(0)
    means, covs = rand_gaussians(rng, 9, 7)
    tm, tc = torch.from_numpy(means), torch.from_numpy(covs)
    jm, jc = jnp.asarray(means), jnp.asarray(covs)
    for i, j in ((0, 1), (3, 7), (5, 5)):
        for name in ("gaussian_kl", "gaussian_js"):
            want = float(getattr(jax_sim, name)(jm[i], jc[i], jm[j], jc[j]))
            got = float(getattr(C, name)(tm[i], tc[i], tm[j], tc[j]))
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), name
    want = np.asarray(jax_sim.pairwise_js(jm, jc))
    got = C.pairwise_js(tm, tc).numpy()
    assert got.shape == (9, 9) and scaled_err(got, want) <= 1e-5
    want = np.asarray(jax_sim.js_to_references(jm, jc, jm[:3], jc[:3]))
    got = C.js_to_references(tm, tc, tm[:3], tc[:3]).numpy()
    assert got.shape == (9, 3) and scaled_err(got, want) <= 1e-5


def test_row_blocks_do_not_change_the_matrix(monkeypatch):
    rng = np.random.default_rng(1)
    means, covs = map(torch.from_numpy, rand_gaussians(rng, 11, 4))
    whole = C.pairwise_js(means, covs)
    monkeypatch.setattr(C.similarity, "ROW_BLOCK", 3)
    assert torch.equal(C.pairwise_js(means, covs), whole)


def test_mixture_js_matches_jax():
    rng = np.random.default_rng(2)
    g, m, lat = 5, 3, 4
    w = rng.dirichlet(np.ones(m), size=g).astype(np.float32)
    w[1] = [1.0, 0.0, 0.0]  # a padded (zero-weight) component drops out
    mus = rng.normal(size=(g, m, lat)).astype(np.float32)
    q = rng.normal(size=(g, m, lat, lat))
    covs = (np.einsum("gmij,gmkj->gmik", q, q) / lat
            + 0.1 * np.eye(lat)).astype(np.float32)
    want = np.asarray(jax_sim.pairwise_gmm_js(*map(jnp.asarray,
                                                   (w, mus, covs))))
    got = C.pairwise_gmm_js(*map(torch.from_numpy, (w, mus, covs))).numpy()
    assert scaled_err(got, want) <= 1e-5
    a = [torch.from_numpy(x[0]) for x in (w, mus, covs)]
    b = [torch.from_numpy(x[2]) for x in (w, mus, covs)]
    want = float(jax_sim.gmm_js(*map(jnp.asarray, (w[0], mus[0], covs[0],
                                                   w[2], mus[2], covs[2]))))
    assert abs(float(C.gmm_js(*a, *b)) - want) <= 1e-5 * max(1.0, want)
    assert abs(float(C.gmm_kl(*a, *b)) - float(jax_sim.gmm_kl(
        *map(jnp.asarray, (w[0], mus[0], covs[0], w[2], mus[2], covs[2]))))
    ) <= 1e-5 * max(1.0, abs(want))


def test_quadratic_form_matches_jax():
    rng = np.random.default_rng(3)
    diff = rng.normal(size=7).astype(np.float32)
    a = rng.normal(size=(7, 7)).astype(np.float32)
    want = float(jax_quadratic_form(jnp.asarray(diff), jnp.asarray(a)))
    got = quadratic_form(torch.from_numpy(diff), torch.from_numpy(a))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    batch = quadratic_form(torch.from_numpy(np.stack([diff, 2 * diff])),
                           torch.from_numpy(a))
    assert batch.shape == (2,) and torch.allclose(batch[1], 4 * batch[0])


# ------------------------------------------------- the latent statistics ----

@pytest.mark.parametrize("masked", [False, True])
def test_latent_stats_and_rows_match_jax(masked):
    jeng, teng = pair()
    probe_tree = jax.tree.map(lambda t: t[2], jeng.states.params)
    probe = flat(jax.tree.map(lambda t: t[None], probe_tree))[0]
    data = teng.data
    jdata = jeng.data
    tm = data.train_mb.clone() if masked else None
    jm = None
    if masked:  # ragged shards: the second half of gateway 1's rows off
        tm[1, tm.shape[1] // 2:] = 0
        jm = jnp.asarray(tm.numpy())
    want = jax_assign.make_latent_stats_fn(jeng.model)(
        probe_tree, jdata.train_xb, jm)
    got = C.make_latent_stats_fn(teng.model)(probe, data.train_xb, tm)
    for g, w in zip(got, want):
        assert scaled_err(g.numpy(), np.asarray(w)) <= 1e-5
    rows = C.make_latent_rows_fn(teng.model)(probe, data.train_xb)
    want_rows = jax_assign.make_latent_rows_fn(jeng.model)(probe_tree,
                                                           jdata.train_xb)
    assert scaled_err(rows.numpy(), np.asarray(want_rows)) <= 1e-5


def test_probe_is_one_forward_launch_over_every_row(monkeypatch):
    from fedmse_tpu_torch.cluster import assign
    calls = []
    real = assign.fused_forward_stats

    def spy(params, x, model_idx=None, **kw):
        calls.append((params["encoder"]["Dense_0"]["kernel"].shape[0],
                      x.shape[0], model_idx))
        return real(params, x, model_idx, **kw)
    monkeypatch.setattr(assign, "fused_forward_stats", spy)
    _, _, data = fleet()
    probe = torch.zeros(LAYOUT.size)
    C.make_latent_stats_fn(make_model("hybrid", *DIMS, device="cpu"))(
        probe, data.train_xb, data.train_mb)
    rows = data.train_xb.shape[1] * data.train_xb.shape[2]
    assert calls == [(1, N * rows, None)]


def test_incumbent_mean_params_matches_jax():
    jeng, teng = pair()
    member = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    want = jax_assign.incumbent_mean_params(jeng.states.params,
                                            jnp.asarray(member))
    got = C.incumbent_mean_params(teng.states.params,
                                  torch.from_numpy(member))
    assert leaf_err(got[None], flat(jax.tree.map(lambda t: t[None],
                                                 want))) <= 1e-6


# ------------------------------------------------------------ the host fit ----

def test_medoids_and_gaussians_are_the_jax_functions():
    rng = np.random.default_rng(4)
    means, covs = rand_gaussians(rng, 10, 3)
    js = np.asarray(jax_sim.pairwise_js(jnp.asarray(means),
                                        jnp.asarray(covs)))
    for k in (1, 3, 12):
        a, m = C.fit_medoids(js, k)
        ja, jm = jax_assign.fit_medoids(js, k)
        assert np.array_equal(a, ja) and np.array_equal(m, jm)
        for x, y in zip(C.cluster_gaussians(means, covs, a, k),
                        jax_assign.cluster_gaussians(means, covs, ja, k)):
            assert np.array_equal(x, y)


def test_gmm_fits_are_the_jax_functions():
    rng = np.random.default_rng(5)
    latents = np.concatenate([rng.normal(-3, 1, (6, 20, 3)),
                              rng.normal(3, 1, (6, 20, 3))], axis=1)
    mask = np.ones((6, 40))
    mask[2, 30:] = 0
    mask[4, :] = 0  # a gateway with no row: a unit Gaussian
    got = C.fit_gateway_gmms(latents, mask, components=2)
    want = jax_assign.fit_gateway_gmms(latents, mask, components=2)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    for x, y in zip(C.moment_match_gmms(*got),
                    jax_assign.moment_match_gmms(*want)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("types,k,sample", [(2, 2, 0), (4, 4, 0),
                                            (4, 4, 6), (2, 3, 0)])
def test_assignments_equal_on_a_typed_fleet(types, k, sample):
    means, covs = typed_stats(types=types, n=12)
    got = C.fit_assignments(means, covs, k, sample=sample, device="cpu")
    want = jax_assign.fit_assignments(means, covs, k, sample=sample)
    assert np.array_equal(got.assignment, want.assignment)
    for f in ("means", "covs", "cl_means", "cl_covs", "counts"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    if types == k:  # well-separated types are recovered exactly
        a = got.assignment
        assert all(len(set(a[np.arange(12) % types == t])) == 1
                   for t in range(types))
        assert len(set(a.tolist())) == types
        assert got.consistency(device="cpu") == want.consistency() == 1.0
    prev = np.roll(got.assignment, 1)
    h = C.refit_with_hysteresis(means, covs, prev, k, 0.3, device="cpu")
    jh = jax_assign.refit_with_hysteresis(means, covs, prev, k, 0.3)
    assert np.array_equal(h.assignment, jh.assignment)
    near = C.nearest_cluster(means, covs, got.cl_means, got.cl_covs,
                             got.counts, device="cpu")
    assert np.array_equal(near, jax_assign.nearest_cluster(
        means, covs, want.cl_means, want.cl_covs, want.counts))


def test_gmm_assignment_equal_on_a_typed_fleet():
    rng = np.random.default_rng(6)
    centers = rng.normal(0, 8.0, size=(2, 3))
    latents = (centers[np.arange(8) % 2][:, None]
               + rng.normal(0, 1.0, size=(8, 30, 3)))
    got = C.fit_assignments_gmm(None, latents, None, 2, device="cpu")
    want = jax_assign.fit_assignments_gmm(None, latents, None, 2)
    assert np.array_equal(got.assignment, want.assignment)
    assert np.array_equal(got.means, want.means)
    assert len(set(got.assignment[::2])) == len(set(got.assignment[1::2])) \
        == 1


@pytest.mark.parametrize("spec_kw", [dict(k=2), dict(k=4),
                                     dict(k=2, metric="gmm")])
def test_engine_fit_matches_jax_on_the_typed_fleet(spec_kw):
    """The engines' one-call fit from one init: the probe, the statistics
    and the medoids give the same assignment (types 8.0 apart)."""
    jeng, teng = pair(spec_kw, fleet_kw=dict(types=4))
    jeng._ensure_cluster_fit(0)
    teng._ensure_cluster_fit(0)
    assert np.array_equal(teng.cluster_assignment, jeng.cluster_assignment)
    assert scaled_err(teng.cluster_fit.means, jeng.cluster_fit.means) <= 1e-5
    if spec_kw["k"] == 4:  # the four device types, recovered
        a = teng.cluster_assignment
        assert sorted(len(set(a[t::4])) for t in range(4)) == [1] * 4
    fit = teng.cluster_fit_seconds
    assert [f["round"] for f in fit] == [0]
    assert fit[0]["encode_s"] > 0 and fit[0]["fit_s"] > 0


@pytest.mark.parametrize("how", ["pad_federated_data", "stack_clients"])
def test_assignment_padding_invariance(how):
    spec = ClusterSpec(k=3)
    engines = []
    for pad in (None, 11):
        if pad is None:
            data = fleet()[2]
        elif how == "stack_clients":
            data = fleet(pad_to=pad)[2]
        else:
            data = pad_federated_data(fleet()[2], pad)
        eng = port_engine(data=data, cluster=spec)
        if pad is not None:  # the padded engine starts from the same init
            eng.states.params[:N] = engines[0].states.params
        eng._ensure_cluster_fit(0)
        engines.append(eng)
    a, b = engines
    assert np.array_equal(a.cluster_assignment, b.cluster_assignment)
    assert np.array_equal(a.cluster_fit.means, b.cluster_fit.means)
    assert np.array_equal(a.cluster_fit.covs, b.cluster_fit.covs)


def test_assignment_extra_round_trip_and_k_change():
    fit = C.fit_assignments(*typed_stats(), 2, fitted_round=3, device="cpu")
    extra = fit.to_extra()
    assert extra == jax_assign.fit_assignments(
        *typed_stats(), 2, fitted_round=3).to_extra()
    spec = ClusterSpec(k=2)
    assert np.array_equal(C.assignment_from_extra(extra, spec, N),
                          fit.assignment)
    assert C.assignment_from_extra({}, spec, N) is None
    for bad, n in ((ClusterSpec(k=3), N), (spec, N + 1)):
        with pytest.raises(ValueError) as got:
            C.assignment_from_extra(extra, bad, n)
        with pytest.raises(ValueError) as want:
            jax_assign.assignment_from_extra(extra, JaxSpec(k=bad.k), n)
        assert str(got.value) == str(want.value)
    assert fit.padded(10).tolist() == fit.assignment.tolist() + [0, 0]


# ------------------------------------------------------------- the merge ----

@pytest.mark.parametrize("update_type", ["mse_avg", "avg"])
@pytest.mark.parametrize("compact", [False, True])
def test_clustered_aggregate_matches_jax(update_type, compact):
    jeng, teng = pair()
    cluster_in = np.asarray([0, 1, 0, 1, 3, 1, 0, 1], np.int64)  # 2: empty
    sel = np.asarray([0, 1, 1, 0, 1, 1, 1, 0], np.float32)
    sel_idx = np.flatnonzero(sel) if compact else None
    want = jax_merge.make_clustered_aggregate_fn(jeng.model, update_type, 4)(
        jeng.states.params, jnp.asarray(sel), jeng.data.dev_x,
        jnp.asarray(cluster_in, jnp.int32),
        sel_idx=None if sel_idx is None else jnp.asarray(sel_idx))
    got = C.make_clustered_aggregate_fn(teng.model, update_type, 4)(
        teng.states.params, torch.from_numpy(sel), teng.data.dev_x,
        torch.from_numpy(cluster_in),
        sel_idx=None if sel_idx is None else torch.from_numpy(sel_idx))
    assert leaf_err(got[0], flat(want[0])) <= 1e-5
    assert scaled_err(got[1].numpy(), np.asarray(want[1])) <= 1e-5
    assert got[2].tolist() == np.asarray(want[2]).tolist() \
        == [True, True, False, True]
    assert torch.equal(got[0][2], torch.zeros(LAYOUT.size))  # never NaN
    for c in (0, 1, 3):
        assert abs(float(got[1][torch.from_numpy(cluster_in == c)].sum())
                   - 1.0) <= 1e-6


def test_sheet_and_gather_match_jax():
    raw = np.asarray([0.5, 0.0, 2.0, 1.0, 0.0], np.float32)
    cin = np.asarray([1, 1, 0, 2, 2])
    got = C.normalize_sheet(torch.from_numpy(raw), torch.from_numpy(cin), 4)
    want = jax_merge.normalize_sheet(jnp.asarray(raw), jnp.asarray(cin), 4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(C.cluster_one_hot(torch.from_numpy(cin), 4).numpy(),
                          np.asarray(jax_merge.cluster_one_hot(
                              jnp.asarray(cin), 4)))
    cp = torch.arange(12.0).view(4, 3)
    assert C.gather_cluster_rows(cp, torch.from_numpy(cin))[:, 0].tolist() \
        == [3.0, 3.0, 0.0, 6.0, 6.0]


def test_personalized_broadcast_and_shared_mask():
    jeng, teng = pair()
    agg = jeng.states.params
    local = jax.tree.map(lambda t: t * 2.0 + 1.0, agg)
    want = jax_merge.personalized_broadcast(agg, local, ("encoder",))
    mask = C.shared_mask(LAYOUT, ("encoder",))
    got = C.personalized_broadcast(flat(agg), flat(local), mask)
    assert torch.equal(got, flat(want))
    enc = LAYOUT.leaves()[3]
    assert int(mask.sum()) == enc[1] + enc[2][0]  # W1, b1, W2, b2
    assert mask[:int(mask.sum())].all() and not mask[int(mask.sum()):].any()
    assert not C.shared_mask(LAYOUT, ()).any()
    with pytest.raises(ValueError) as got_err:
        C.shared_mask(LAYOUT, ("head",))
    with pytest.raises(ValueError) as want_err:
        jax_merge.personalized_broadcast(agg, local, ("head",))
    assert str(got_err.value) == str(want_err.value)


def test_clustered_incumbent_means_match_jax():
    jeng, teng = pair()
    inc = np.asarray([1, 1, 0, 1, 0, 0, 1, 0], np.float32)
    cin = np.asarray([0, 0, 1, 2, 2, 3, 3, 2])  # cluster 1: no incumbent
    want = jax_merge.clustered_incumbent_means(
        jeng.states.params, jnp.asarray(inc), jnp.asarray(cin), 4)
    got = C.clustered_incumbent_means(teng.states.params,
                                      torch.from_numpy(inc),
                                      torch.from_numpy(cin), 4)
    assert leaf_err(got, flat(want)) <= 1e-5
    fleet_mean = C.incumbent_mean_params(teng.states.params,
                                         torch.from_numpy(inc))
    assert torch.equal(got[2], fleet_mean)


def test_cluster_models_take_flat_and_jax_trees():
    jeng, _ = pair()
    tree = jax.tree.map(lambda t: np.asarray(t)[:3], jeng.states.params)
    assignment = [2, 0, 0, 1, 2]
    want = jax_merge.cluster_models(tree, np.asarray(assignment))
    got_tree = C.cluster_models(tree, assignment)
    assert torch.equal(LAYOUT.flatten(got_tree), flat(want))
    assert torch.equal(C.cluster_models(flat(tree), assignment), flat(want))


# -------------------------------------------------------------- the vote ----

@pytest.mark.parametrize("case", [
    # (scores, sel, sel_mask, agg_count, cluster_in)
    ([0.3, 0.1, 0.2, 0.5, 0.4, 0.6], [4, 1, 2, 5], [0, 1, 1, 0, 1, 1],
     [0] * 6, [0, 1, 1, 0, 0, 1]),
    # voter 4's cluster has no other candidate: it passes its turn
    ([0.3, 0.1, 0.2, 0.5, 0.4, 0.6], [4, 1, 2, 5], [0, 1, 1, 0, 1, 1],
     [0] * 6, [0, 1, 1, 1, 0, 1]),
    # NaN ranks worst, quota-exhausted clients are no candidates
    ([np.nan, 0.1, 0.2, 0.05, 0.4, np.nan], [0, 3, 5, 1, 2],
     [1, 1, 1, 1, 0, 1], [0, 3, 0, 0, 0, 0], [0, 0, 0, 1, 1, 0]),
    # every voter alone in its cluster: no aggregator
    ([0.3, 0.1, 0.2, 0.5, 0.4, 0.6], [0, 1, 2], [1, 1, 1, 0, 0, 0],
     [0] * 6, [0, 1, 2, 0, 1, 2]),
])
def test_cluster_scoped_election_matches_jax(case):
    scores, sel, mask, count, cin = (np.asarray(x) for x in case)
    scores = scores.astype(np.float32)
    want_agg, want_scores = jax_elect(
        lambda *a: jnp.asarray(scores), None, jnp.asarray(sel, jnp.int32),
        jnp.asarray(mask, jnp.float32), jnp.asarray(count, jnp.int32),
        None, None, jax.random.PRNGKey(0), 3,
        cluster_in=jnp.asarray(cin, jnp.int32))
    agg, got_scores = elect_on_device(
        torch.from_numpy(scores), None, torch.from_numpy(sel),
        torch.tensor(mask, dtype=torch.float32),
        torch.tensor(count, dtype=torch.int32), 3,
        cluster_in=torch.from_numpy(cin))
    assert int(agg) == int(want_agg)
    assert np.array_equal(got_scores.numpy(), np.asarray(want_scores),
                          equal_nan=True)


# ---------------------------------------------------- the clustered round ----

@pytest.mark.parametrize("spec_kw,assignment,extra", [
    (dict(k=2), [1, 0, 1, 0, 1, 0, 1, 0], {}),
    (dict(k=4), [2, 1, 0, 1, 2, 1, 3, 1], {}),
    (dict(k=2, personalize=True), [1, 0, 1, 0, 1, 0, 1, 0], {}),
    (dict(k=1, personalize=True), [0] * N, {}),
    (dict(k=2), [1, 0, 1, 0, 1, 0, 1, 0],
     dict(attack=dict(kind="scale", strength=5.0, start_round=1))),
    (dict(k=3), [2, 0, 1, 0, 2, 0, 1, 1],
     dict(update_type="fedprox", hardened_verification=True,
          num_participants=0.75)),
])
def test_clustered_fused_rounds_match_jax(spec_kw, assignment, extra):
    jeng, teng = pair(spec_kw, assignment, **extra)
    jres, tres = [], []
    for r in range(3):
        sel = jeng.select_clients()
        jres.append(jeng.run_round(r, selected=sel))
        tres.append(teng.run_round(r, selected=sel))
    assert any(r.aggregator is not None for r in tres)
    assert_engines_agree(jeng, teng, jres, tres)
    assert teng.fused_round().clustered


def test_a_clustered_chunk_is_its_rounds():
    """A chunk of 3 clustered rounds equals 3 rounds one at a time (the
    assignment buffer written once per chunk)."""
    a = port_engine(cluster=ClusterSpec(k=2))
    b = port_engine(cluster=ClusterSpec(k=2))
    b.states = a.states.clone()
    chunk = a.run_rounds(0, 3)
    single = [b.run_round_fused(r) for r in range(3)]
    for x, y in zip(chunk, single):
        assert_same_round(x, y, observables=False)
    assert_same_states(a.states, b.states)


def test_k1_is_bit_equal_to_no_spec():
    plain = port_engine()
    null = port_engine(cluster=ClusterSpec(k=1), states=plain.states.clone())
    rp, rn = plain.run_rounds(0, 3), null.run_rounds(0, 3)
    for a, b in zip(rp, rn):
        assert_same_round(b, a)
    assert_same_states(null.states, plain.states)
    assert null.cluster_assignment is None and not null.clustered
    fp, fn = plain.fused_round(), null.fused_round()
    assert not fn.clustered and fn.cluster_in is None
    assert fn.input_names == fp.input_names
    assert fn.out.width == fp.out.width


def test_clustered_engine_needs_the_fused_round():
    for kw in (dict(fused=False), dict(profile=True)):
        cfg = port_cfg()
        with pytest.raises(ValueError, match="fused round program"):
            RoundEngine(make_model("hybrid", *DIMS, device="cpu"), cfg,
                        fleet()[2], n_real=N, rngs=ExperimentRngs(run=0),
                        model_type="hybrid", update_type="avg",
                        cluster=ClusterSpec(k=2), **kw)
    # the null spec builds nothing and runs on the per-phase path too
    RoundEngine(make_model("hybrid", *DIMS, device="cpu"), port_cfg(),
                fleet()[2], n_real=N, rngs=ExperimentRngs(run=0),
                model_type="hybrid", update_type="avg",
                cluster=ClusterSpec(k=1)).run_round(0)


def test_an_empty_cluster_leaves_its_clients_untouched():
    """Cluster 1 holds only clients the round does not select: no merge is
    made for it, and its clients keep their whole state."""
    eng = port_engine(cluster=ClusterSpec(k=2),
                      cluster_assignment=[0, 0, 0, 0, 1, 1, 1, 1],
                      cfg=port_cfg(num_participants=0.5))
    before = eng.states.clone()
    res = eng.run_round_fused(0, selected=[0, 2, 1, 3])
    assert res.aggregator in (0, 1, 2, 3)
    outside = torch.arange(4, 8)
    for name in ("params", "prev_global", "hist_params", "hist_perf",
                 "hist_seen", "rejected"):
        a, b = getattr(eng.states, name), getattr(before, name)
        assert torch.equal(a[outside], b[outside]), name
    assert not torch.isnan(eng.states.params).any()
    assert np.all(res.agg_weights[4:] == 0)
    inside = eng.states.params[:4]
    assert torch.equal(inside, inside[:1].expand(4, -1))  # one merge


def test_elastic_join_inherits_its_own_clusters_mean():
    """A join recycles from the nearest cluster's incumbent mean. The
    joiner comes from a cluster of at least two members (a cluster of one
    would leave it no incumbent), and nothing else moves it that round:
    no aggregator is possible when only the joiner is selected."""
    assignment = np.asarray([0, 0, 0, 1, 1, 1, 1, 0], np.int32)
    joiner = 3
    t = 2
    masks = (np.ones((t, N), np.float32), np.zeros((t, N), np.float32),
             np.zeros((t, N), np.float32), np.zeros((t, N), np.int32))
    masks[1][0, joiner] = 1.0
    masks[3][:, joiner] = 1
    jeng, teng = pair(dict(k=2), assignment, elastic=dict(join_p=0.1),
                      elastic_masks=masks)
    pre = teng.states.params.clone()
    want = jeng.run_round(0, selected=[joiner])
    got = teng.run_round(0, selected=[joiner])
    assert got.aggregator is None and want.aggregator is None
    members = np.flatnonzero((assignment == 1)
                             & (np.arange(N) != joiner))
    mean = pre[members].mean(dim=0)
    assert float((teng.states.prev_global[joiner] - mean).abs().max()) \
        <= 1e-6 * float(mean.abs().max())
    assert leaf_err(teng.states.prev_global, flat(jeng.states.prev_global)) \
        <= 1e-5
    fleet_mean = pre[np.arange(N) != joiner].mean(dim=0)
    assert not torch.allclose(teng.states.prev_global[joiner], fleet_mean)


# ------------------------------------------------ checkpoints and resume ----

def _jax_extra(spec, eng, fitted_round):
    return {"flatten_optimizer": False, "elastic": None,
            "cluster": spec.signature(), "elastic_generation": None,
            "cluster_k": spec.k,
            "cluster_assignment": eng.cluster_assignment.tolist(),
            "cluster_fitted_round": fitted_round}


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    spec_kw = dict(k=2, refit_every=5)
    jeng, teng = pair(spec_kw)
    for r in range(2):
        jeng.run_round(r)
    JaxManager(str(tmp_path)).save_shard(
        TAG, jax.tree.map(np.asarray, jeng.states), jeng.host, 2, 0, N,
        [(0, N)], extra=_jax_extra(jeng.cluster, jeng, 0))
    mgr = CheckpointManager(str(tmp_path))
    extra = mgr.extra(TAG)
    vec = C.assignment_from_extra(extra, teng.cluster, N)
    teng.set_cluster_assignment(vec, extra["cluster_fitted_round"])
    teng.states, teng.host, start, _ = mgr.restore(
        TAG, layout=LAYOUT, device="cpu",
        expected_extra={"cluster": teng.cluster.signature()})
    assert start == 2
    sel = jeng.select_clients()
    want, got = jeng.run_round(2, selected=sel), teng.run_round(2,
                                                                selected=sel)
    assert np.array_equal(teng.cluster_assignment, jeng.cluster_assignment)
    assert teng.cluster_fit_seconds == []  # pinned: no refit
    assert_engines_agree(jeng, teng, [want], [got])
    # the driver resumes it too, under the recorded assignment
    cfg = port_cfg(num_rounds=3, fused_schedule_chunk=1)
    out = run_combination(cfg, teng.data, N, "hybrid", "mse_avg", 0,
                          resume=mgr, cluster=ClusterSpec(**spec_kw))
    assert out["rounds_run"] == 1
    assert np.array_equal(out["engine"].cluster_assignment,
                          jeng.cluster_assignment)
    with pytest.raises(ValueError, match="cluster_k=2 but this run uses "
                                         "cluster_k=3"):
        run_combination(cfg, teng.data, N, "hybrid", "mse_avg", 0,
                        resume=mgr, cluster=ClusterSpec(k=3))


def test_port_snapshot_resumes_in_jax(tmp_path):
    spec_kw = dict(k=2)
    cfg = port_cfg(num_rounds=2, fused_schedule_chunk=1)
    jeng, teng = pair(spec_kw)
    mgr = CheckpointManager(str(tmp_path))
    run_combination(cfg, teng.data, N, "hybrid", "mse_avg", 0, resume=mgr,
                    cluster=ClusterSpec(**spec_kw),
                    states=teng.states.clone())
    extra = mgr.extra(TAG)
    assert {k: extra[k] for k in ("cluster", "cluster_k",
                                  "cluster_fitted_round")} == {
        "cluster": JaxSpec(**spec_kw).signature(), "cluster_k": 2,
        "cluster_fitted_round": 0}
    vec = jax_assign.assignment_from_extra(
        JaxManager(str(tmp_path)).pod_extra(TAG), jeng.cluster, N)
    jeng.set_cluster_assignment(vec, extra["cluster_fitted_round"])
    states, host, start, _ = JaxManager(str(tmp_path)).restore_sharded(
        TAG, jeng.states, 0, N,
        expected_extra={"cluster": jeng.cluster.signature()})
    assert start == 2
    jeng.states, jeng.host = jax.tree.map(jnp.asarray, states), host
    teng.set_cluster_assignment(vec)
    teng.states, teng.host, _, _ = mgr.restore(TAG, layout=LAYOUT,
                                               device="cpu")
    sel = teng.select_clients()
    want, got = jeng.run_round(2, selected=sel), teng.run_round(2,
                                                                selected=sel)
    assert_engines_agree(jeng, teng, [want], [got])


def test_killed_clustered_run_resumes_bit_for_bit(tmp_path):
    spec = ClusterSpec(k=2, refit_every=1, personalize=True)
    cfg = port_cfg(num_rounds=3, fused_schedule_chunk=1)
    data = fleet()[2]
    whole = run_combination(cfg, data, N, "hybrid", "mse_avg", 0,
                            cluster=spec)
    mgr = CheckpointManager(str(tmp_path))
    first = run_combination(cfg.replace(num_rounds=2), data, N, "hybrid",
                            "mse_avg", 0, resume=mgr, cluster=spec)
    rest = run_combination(cfg, data, N, "hybrid", "mse_avg", 0, resume=mgr,
                           cluster=spec)
    assert (first["rounds_run"], rest["rounds_run"]) == (2, 1)
    for a, b in zip(first["rounds"] + rest["rounds"], whole["rounds"]):
        assert_same_round(a, b)
    assert_same_states(rest["engine"].states, whole["engine"].states)
    assert [f["round"] for f in whole["engine"].cluster_fit_seconds] == \
        [0, 1, 2]


# ------------------------------------------------- the pipeline and the CLI ----

@pytest.mark.parametrize("spec", [ClusterSpec(k=2, refit_every=1),
                                  ClusterSpec(k=3, refit_every=3)])
def test_pipelined_refit_equals_serial(spec):
    """With a refit due at a chunk's entry, the pipelined loop waits for
    the previous chunk: its fits read the same states as the serial
    loop's, so the runs are the same bits."""
    cfg = port_cfg(num_rounds=6, fused_schedule_chunk=2)
    data = fleet()[2]
    outs = {}
    for pipelined in (True, False):
        eng = port_engine(cfg, data, cluster=spec)
        results = []
        stats = run_pipelined_schedule(
            eng, 0, 6, 2, lambda res, sec: results.extend(res),
            can_rewind=False, pipelined=pipelined)
        outs[pipelined] = (eng, results, stats)
    (pe, pr, ps), (se, sr, _) = outs[True], outs[False]
    for a, b in zip(pr, sr):
        assert_same_round(a, b)
    assert_same_states(pe.states, se.states)
    fits = [f["round"] for f in pe.cluster_fit_seconds]
    assert fits == [f["round"] for f in se.cluster_fit_seconds]
    assert fits == ([0, 2, 4] if spec.refit_every == 1 else [0, 4])
    # the pipelined loop overlapped exactly the boundaries with no refit
    assert ps.summary()["chunks"] == 3
    assert len(ps.host_gaps) == (0 if spec.refit_every == 1 else 1)


def test_a_rewind_replays_under_its_chunks_assignment():
    """A stop inside a chunk replays the chunk's prefix under the
    assignment the chunk ran with: no refit in the replay, the states of
    the same rounds run in one chunk."""
    spec = ClusterSpec(k=2, refit_every=1)
    cfg = port_cfg(num_rounds=6, fused_schedule_chunk=3)
    data = fleet()[2]
    stopped = port_engine(cfg, data, cluster=spec)
    seen = []

    def consume(results, sec):
        seen.append(len(results))
        return 1 if len(seen) == 1 else None
    run_pipelined_schedule(stopped, 0, 6, 3, consume)
    assert seen == [3]
    want = port_engine(cfg, data, cluster=spec)
    want.run_rounds(0, 2)
    assert_same_states(stopped.states, want.states)
    assert [f["round"] for f in stopped.cluster_fit_seconds] == [0]


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("cluster_shards")
    for k in range(1, N + 1):
        shift = 6.0 * (k % 2)  # two device types
        for split, n, s in (("normal", 80, shift), ("abnormal", 30, 4.0),
                            ("test_normal", 15, shift)):
            d = root / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(s, 1.0, (n, 12)),
                       delimiter=",")
    path = root / "config.json"
    path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(root), N).to_json()))
    return str(path)


def test_cli_cluster_end_to_end(dataset_json, tmp_path, caplog):
    from fedmse_tpu_torch.main import main
    caplog.set_level(logging.INFO)
    out = main(["--dataset-config", dataset_json, "--device", "cpu",
                "--model-types", "hybrid", "--update-types", "mse_avg",
                "--network-size", str(N), "--dim-features", "12",
                "--epochs", "1", "--batch-size", "8", "--no-save",
                "--num-rounds", "3", "--fused-schedule-chunk", "1",
                "--cluster-k", "2", "--cluster-refit-every", "2",
                "--checkpoint-dir", str(tmp_path), "--experiment-name",
                "cl"])
    assert out["cluster"] == {
        "k": 2, "personalize": False, "refit_every": 2, "metric": "js",
        "hysteresis": 0.0, "gmm_components": 2,
        "shared_modules": ("encoder",), "fit_sample": 4096}
    assert np.isfinite(out["results"]["hybrid/mse_avg/run0"]
                       ["final_metrics"]).all()
    tree = "cl_cluster-k2p0r2mjssencoder"
    assert glob.glob(str(tmp_path / "Results" / "Update" / str(N) / tree /
                         "**" / "*.json"), recursive=True)
    fits = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("cluster fit at round")]
    assert [f.split(":")[0] for f in fits] == ["cluster fit at round 0",
                                               "cluster fit at round 2"]
    from fedmse_tpu_torch.main import build_parser, cluster_spec
    with pytest.raises(ValueError, match="refit_every must be >= 0"):
        cluster_spec(build_parser().parse_args(
            ["--dataset-config", "x", "--cluster-personalize",
             "--cluster-k", "0", "--cluster-refit-every", "-1"]),
            port_cfg())
