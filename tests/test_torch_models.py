"""The port's models and ops (fedmse_tpu_torch/models, ops) against the
JAX package's: the same seeded numpy inputs through both, f32 tolerance
1e-5 (reduction order is the only difference)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.models import centroid as jax_centroid
from fedmse_tpu.models import init_client_params, make_model as jax_make_model
from fedmse_tpu.ops import distance as jax_distance
from fedmse_tpu.ops import losses as jax_losses
from fedmse_tpu.ops import metrics as jax_metrics
from fedmse_tpu.ops import stats as jax_stats
from fedmse_tpu_torch.models import (fit_centroid, init_stacked_params,
                                     make_model, params_from_numpy)
from fedmse_tpu_torch.ops import distance, losses, metrics, stats
from fedmse_tpu_torch.ops.precision import cast_params, get_policy

torch.set_num_threads(1)

T = torch.from_numpy


def close(got, want, tol=1e-5):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
@pytest.mark.parametrize("dims", [(115, 27, 7), (16, 8, 3)])
def test_forward_and_loss_match_flax_apply(model_type, dims):
    d, h, lat = dims
    jm = jax_make_model(model_type, d, h, lat, shrink_lambda=5.0)
    jp = jax.tree.map(np.asarray, init_client_params(jm, jax.random.key(1)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, d)).astype(np.float32)
    mask = (rng.random(50) < 0.7).astype(np.float32)
    jl, jr = jm.apply({"params": jp}, jnp.asarray(x))

    pm = make_model(model_type, d, h, lat, shrink_lambda=5.0, device="cpu")
    params = params_from_numpy(jp, device="cpu")
    pm.load_param_tree(params)
    lat_t, rec_t = pm(T(x))
    close(lat_t, jl)
    close(rec_t, jr)
    close(pm.loss(T(x), lat_t, rec_t, T(mask)),
          jm.loss(jnp.asarray(x), jl, jr, jnp.asarray(mask)))
    # apply_params with per-row model indices over a 2-model stack
    two = params_from_numpy(
        jax.tree.map(lambda t: np.stack([t, 0.5 * t]), jp), device="cpu")
    idx = T(rng.integers(0, 2, 50).astype(np.int32))
    lat2, _ = pm.apply_params(two, T(x), idx)
    close(lat2[idx == 0], np.asarray(jl)[(idx == 0).numpy()])


def test_own_init_shapes_bounds_and_generator():
    m = make_model("hybrid", 115, device="cpu")
    g = torch.Generator().manual_seed(3)
    p = init_stacked_params(m, 4, g, device="cpu")
    k = p["encoder"]["Dense_0"]["kernel"]
    assert k.shape == (4, 115, 27) and k.abs().max() <= 1 / 115 ** 0.5
    assert (p["decoder"]["Dense_1"]["bias"] == 0).all()
    again = init_stacked_params(m, 4, torch.Generator().manual_seed(3),
                                device="cpu")
    assert torch.equal(k, again["encoder"]["Dense_0"]["kernel"])
    assert not torch.equal(k[0], k[1])
    cp = cast_params(p, get_policy("bf16").compute_dtype)
    assert cp["encoder"]["Dense_0"]["kernel"].dtype == torch.bfloat16
    assert cp["encoder"]["Dense_0"]["bias"].dtype == torch.float32


@pytest.mark.parametrize("lam", [0.0, 5.0])
def test_losses_including_empty_mask(lam):
    rng = np.random.default_rng(1)
    x, r = rng.normal(size=(2, 12, 9)).astype(np.float32)
    z = rng.normal(size=(12, 4)).astype(np.float32)
    z[3] = 0.0  # the safe norm's zero latent
    for mask in (None, (rng.random(12) < 0.5).astype(np.float32),
                 np.zeros(12, np.float32)):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else T(mask)
        want = jax_losses.shrink_loss(jnp.asarray(x), jnp.asarray(r),
                                      jnp.asarray(z), lam, jm)
        got = losses.shrink_loss(T(x), T(r), T(z), lam, tm)
        if mask is not None and mask.sum() == 0:
            assert np.isnan(float(want)) and torch.isnan(got)
        else:
            close(got, want)
        close(losses.per_sample_mse(T(x), T(r)),
              jax_losses.per_sample_mse(jnp.asarray(x), jnp.asarray(r)))
    assert torch.isnan(losses.mse_loss(T(x), T(r), torch.zeros(12)))


def test_centroid_fit_and_density_masked_and_batched():
    rng = np.random.default_rng(2)
    lat = rng.normal(1.0, 2.0, size=(3, 40, 5)).astype(np.float32)
    lat[:, :, 2] = 0.5  # zero-variance column -> scale 1.0 (exact sums)
    mask = (rng.random((3, 40)) < 0.8).astype(np.float32)
    test = rng.normal(size=(3, 25, 5)).astype(np.float32)
    cen = fit_centroid(T(lat), T(mask))
    dens = cen.get_density(T(test))
    for g in range(3):
        jc = jax_centroid.fit_centroid(jnp.asarray(lat[g]),
                                       jnp.asarray(mask[g]))
        close(cen.mean[g], jc.mean)
        close(cen.scale[g], jc.scale)
        close(cen.abs_threshold[g], jc.abs_threshold)
        close(dens[g], jc.get_density(jnp.asarray(test[g])))
        close(cen.take(torch.tensor([g])).get_density(T(test[g, :1])),
              jc.get_density(jnp.asarray(test[g, :1])))
    mean, std = stats.masked_mean_std(T(lat[0]), T(mask[0]), ddof=1)
    jmean, jstd = jax_stats.masked_mean_std(jnp.asarray(lat[0]),
                                            jnp.asarray(mask[0]), ddof=1)
    close(mean, jmean)
    close(std, jstd)


@pytest.mark.parametrize("n_valid", [1, 2, 7, 30])
@pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 100.0])
def test_masked_percentile(n_valid, q):
    rng = np.random.default_rng(n_valid)
    v = rng.normal(size=30).astype(np.float32)
    mask = np.zeros(30, np.float32)
    mask[rng.permutation(30)[:n_valid]] = 1.0
    got = stats.masked_percentile(T(v), q, T(mask))
    close(got, jax_stats.masked_percentile(jnp.asarray(v), q,
                                           jnp.asarray(mask)))
    close(got, np.percentile(v[mask > 0], q))


def test_roc_auc_and_classification_with_ties_and_masks():
    rng = np.random.default_rng(4)
    labels = (rng.random((4, 60)) < 0.4).astype(np.float32)
    scores = np.round(rng.normal(size=(4, 60)), 1).astype(np.float32)  # ties
    mask = (rng.random((4, 60)) < 0.85).astype(np.float32)
    labels[3] = 0.0  # one class only -> NaN
    auc = metrics.roc_auc(T(labels), T(scores), T(mask))
    f1, prec, rec = metrics.classification_metrics(T(labels), T(scores),
                                                   T(mask))
    for g in range(4):
        want = jax_metrics.roc_auc(jnp.asarray(labels[g]),
                                   jnp.asarray(scores[g]),
                                   jnp.asarray(mask[g]))
        if g == 3:
            assert np.isnan(float(want)) and torch.isnan(auc[g])
        else:
            close(auc[g], want)
        jf1, jp, jr = jax_metrics.classification_metrics(
            jnp.asarray(labels[g]), jnp.asarray(scores[g]),
            jnp.asarray(mask[g]))
        close(f1[g], jf1)
        close(prec[g], jp)
        close(rec[g], jr)


def test_distances():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(6, 7)).astype(np.float32)
    b = rng.normal(size=(9, 7)).astype(np.float32)
    close(distance.pairwise_sq_dists(T(q), T(b)),
          jax_distance.pairwise_sq_dists(jnp.asarray(q), jnp.asarray(b)))
    close(distance.norm_to_origin(T(q)),
          jax_distance.norm_to_origin(jnp.asarray(q)))
    close(distance.row_norms_packed(T(q)),
          jax_distance.row_norms_packed(jnp.asarray(q)))
    close(distance.sq_norms(T(q).bfloat16()),
          jax_distance.sq_norms(jnp.asarray(q, jnp.bfloat16)))


# the port's own fields, which the JAX package has no model for (KitNET's
# knobs): a JAX config leaves them at their defaults
PORT_ONLY = {"kitnet_max_ae": 10, "kitnet_hidden_ratio": 0.75}


def test_config_reads_the_jax_json_layout():
    from fedmse_tpu.config import ExperimentConfig as JaxConfig
    from fedmse_tpu_torch.config import ExperimentConfig

    raw = JaxConfig(precision="bf16", serve_max_batch=512).to_json()
    cfg = ExperimentConfig.from_json(raw)
    for f in dataclasses.fields(cfg):
        got = getattr(cfg, f.name)
        if dataclasses.is_dataclass(got):  # the nested compat switches
            got = dataclasses.asdict(got)
        assert got == {**raw, **PORT_ONLY}[f.name], f.name
    assert cfg.replace(latent_dim=3).latent_dim == 3


def test_cli_overrides_and_seeding_match_jax():
    import argparse

    from fedmse_tpu.config import ExperimentConfig as JaxConfig
    from fedmse_tpu.config import add_cli_overrides as jax_add
    from fedmse_tpu.config import apply_cli_overrides as jax_apply
    from fedmse_tpu.config import paper_scale as jax_paper
    from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
    from fedmse_tpu_torch.config import (ExperimentConfig, add_cli_overrides,
                                         apply_cli_overrides, paper_scale)
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    argv = ["--num-rounds", "7", "--model-types", "hybrid",
            "--compat-vote-tie-break", "false", "--compact-cohort", "false",
            "--hardened-verification", "true", "--lr-rate", "0.01",
            "--recovery-budget", "2.5"]
    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_cli_overrides(ours)
    jax_add(theirs)
    cfg = paper_scale(apply_cli_overrides(ExperimentConfig(),
                                          ours.parse_args(argv)))
    jargs, _ = theirs.parse_known_args(argv)
    want = jax_paper(jax_apply(JaxConfig(), jargs)).to_json()
    want["recovery_budget"] = 2.5  # the JAX CLI has no flag for it
    got = cfg.to_json()
    want.update(PORT_ONLY)
    assert {k: got[k] for k in got} == {k: want[k] for k in got}
    for run in (0, 2):
        a, b = ExperimentRngs(run=run), JaxRngs(run=run)
        assert a.select_rng.sample(range(10), 5) == \
            b.select_rng.sample(range(10), 5)
        np.testing.assert_array_equal(a.data_rng.permutation(20),
                                      b.data_rng.permutation(20))
