"""The port's scoring slice end to end (fedmse_tpu_torch/evaluation,
serving, checkpointing) against the JAX package: the same seeded data and
JAX-initialized params through both.

Tolerances: per-row scores 1e-5 (f32; reduction order only), AUC within
2e-3 (PARITY.md §7's bar). bf16 is quality-pinned, not bit-pinned: its AUC
stays within 2e-3 of the port's own f32 run.
"""

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.checkpointing import ResultsWriter as JaxWriter
from fedmse_tpu.checkpointing import save_client_models as jax_save
from fedmse_tpu.data import stack_clients as jax_stack_clients
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.evaluation import make_evaluate_all as jax_evaluate_all
from fedmse_tpu.models import init_stacked_params as jax_init_params
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.serving import ServingEngine as JaxEngine
from fedmse_tpu.serving import fit_calibration as jax_fit_calibration
from fedmse_tpu_torch.checkpointing import (ResultsWriter, load_client_models,
                                            save_client_models)
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.models import make_model, params_from_numpy
from fedmse_tpu_torch.serving import (MicroBatcher, ServingCalibration,
                                      ServingEngine, ServingRoster,
                                      UnknownGatewayError, fit_calibration)

torch.set_num_threads(1)

DIM, N, BATCH = 12, 3, 12
MODEL_TYPES = ["autoencoder", "hybrid"]


def _clients(mod):
    return mod(n_clients=N, dim=DIM, n_normal=100, n_abnormal=40, seed=3)


@pytest.fixture(scope="module")
def fed():
    """Port data, JAX data and JAX-initialized params, shared per module."""
    dev_x = np.zeros((4, DIM), np.float32)
    data = stack_clients(_clients(synthetic_clients), dev_x, BATCH,
                         device="cpu")
    jdata = jax_stack_clients(_clients(jax_synthetic), dev_x, BATCH)
    params = {}
    for mt in MODEL_TYPES:
        jm = jax_make_model(mt, DIM, shrink_lambda=1.0)
        params[mt] = jax.tree.map(
            np.asarray, jax_init_params(jm, jax.random.key(7), N))
    return data, jdata, params


def _models(mt, precision="f32"):
    return (jax_make_model(mt, DIM, shrink_lambda=1.0),
            make_model(mt, DIM, shrink_lambda=1.0, precision=precision,
                       device="cpu"))


def _eval_args(data):
    return (data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb)


def _port_engine(mt, fed, **kw):
    data, _, params = fed
    _, model = _models(mt)
    return ServingEngine.from_federation(
        model, mt, params[mt], data.train_xb, data.train_mb, max_bucket=8,
        device="cpu", **kw)


def _jax_engine(mt, fed, **kw):
    _, jdata, params = fed
    jm, _ = _models(mt)
    return JaxEngine.from_federation(
        jm, mt, params[mt], train_x=np.asarray(jdata.train_xb),
        train_m=np.asarray(jdata.train_mb), max_bucket=8,
        bucket_ladder="pow2", **kw)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_evaluator_matches_jax(model_type, fed):
    data, jdata, params = fed
    jm, model = _models(model_type)
    tparams = params_from_numpy(params[model_type], device="cpu")
    jargs = tuple(np.asarray(t) for t in _eval_args(jdata))
    scores = make_evaluate_all(model, model_type, metric="scores")(
        tparams, *_eval_args(data))
    want = jax_evaluate_all(jm, model_type, metric="scores")(
        params[model_type], *jargs)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    auc = make_evaluate_all(model, model_type)(tparams, *_eval_args(data))
    jauc = jax_evaluate_all(jm, model_type)(params[model_type], *jargs)
    np.testing.assert_allclose(auc.numpy(), np.asarray(jauc), atol=2e-3)
    cls = make_evaluate_all(model, model_type, metric="classification")(
        tparams, *_eval_args(data))
    jcls = jax_evaluate_all(jm, model_type, metric="classification")(
        params[model_type], *jargs)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=2e-3)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_bf16_auc_within_2e3_of_f32(model_type, fed):
    data, _, params = fed
    aucs = {}
    for precision in ("f32", "bf16"):
        _, model = _models(model_type, precision)
        data_p = stack_clients(_clients(synthetic_clients),
                               np.zeros((4, DIM), np.float32), BATCH,
                               dtype=model.compute_dtype, device="cpu")
        aucs[precision] = make_evaluate_all(model, model_type)(
            params_from_numpy(params[model_type], device="cpu"),
            *_eval_args(data_p)).numpy()
    assert np.isfinite(aucs["bf16"]).all()
    np.testing.assert_allclose(aucs["bf16"], aucs["f32"], atol=2e-3)


@pytest.mark.parametrize("routing", ["gather", "dense", "single"])
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_engine_matches_jax_engine_at_every_bucket(model_type, routing, fed):
    data = fed[0]
    test_x = data.test_x.numpy()
    if routing == "single":
        g = 1
        jm, model = _models(model_type)
        p1 = jax.tree.map(lambda t: t[g], fed[2][model_type])
        jeng_full = _jax_engine(model_type, fed)
        cen = (None if jeng_full.centroids is None else
               jax.tree.map(lambda t: np.asarray(t[g]), jeng_full.centroids))
        jeng = JaxEngine(jm, model_type, p1, cen, multi_tenant=False,
                         max_bucket=8, bucket_ladder="pow2")
        eng_full = _port_engine(model_type, fed)
        tcen = (None if eng_full.centroids is None
                else eng_full.centroids.take(g))
        eng = ServingEngine(model, model_type, p1, tcen, multi_tenant=False,
                            max_bucket=8, device="cpu")
        rows, gws = test_x[g, :19], None
    else:
        eng = _port_engine(model_type, fed, routing=routing)
        jeng = _jax_engine(model_type, fed, routing=routing)
        rng = np.random.default_rng(0)
        gws = rng.integers(0, N, 19).astype(np.int32)
        rows = test_x[gws, np.arange(19)]
    for n_rows in (1, 2, 3, 4, 5, 7, 8, 19):
        gw = None if gws is None else gws[:n_rows]
        np.testing.assert_allclose(eng.score(rows[:n_rows], gw),
                                   jeng.score(rows[:n_rows], gw),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{routing} n={n_rows}")
    assert sorted(eng.dispatches) == [1, 2, 4, 8]
    pend = eng.dispatch(rows[:5], None if gws is None else gws[:5])
    assert pend.is_ready()
    np.testing.assert_array_equal(pend.harvest(), eng.score(
        rows[:5], None if gws is None else gws[:5]))


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_jax_written_checkpoint_serves_in_port(model_type, fed, tmp_path):
    data, jdata, params = fed
    jm, model = _models(model_type)
    names = [f"Client-{k}" for k in range(1, N + 1)]
    jwriter = JaxWriter(str(tmp_path), N, "exp", "FL-IoT", "AUC", 0.5)
    jax_save(jwriter, 0, model_type, "mse_avg", names, params[model_type])
    writer = ResultsWriter(str(tmp_path), N, "exp", "FL-IoT", "AUC", 0.5)
    assert writer.client_model_dir(0, model_type, "mse_avg", names[0]) == \
        jwriter.client_model_dir(0, model_type, "mse_avg", names[0])
    assert writer.serving_dir(0) == jwriter.serving_dir(0)
    eng = ServingEngine.from_checkpoint(
        writer, model, model_type, "mse_avg", names, run=0,
        train_x=data.train_xb, train_m=data.train_mb, max_bucket=8,
        device="cpu")
    oracle = make_evaluate_all(model, model_type, metric="scores")(
        params_from_numpy(params[model_type], device="cpu"),
        *_eval_args(data)).numpy()
    for g in range(N):
        np.testing.assert_allclose(eng.score(data.test_x[g, :21].numpy(), g),
                                   oracle[g, :21], rtol=1e-5, atol=1e-5)
    # and the port's own writer round-trips exactly
    save_client_models(writer, 1, model_type, "avg", names, eng.params)
    back = load_client_models(writer, 1, model_type, "avg", names,
                              device="cpu")
    for coder in ("encoder", "decoder"):
        for layer in ("Dense_0", "Dense_1"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    back[coder][layer][leaf].numpy(),
                    params[model_type][coder][layer][leaf])


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_calibration_and_batcher_verdicts(model_type, fed, tmp_path):
    data, jdata, _ = fed
    eng = _port_engine(model_type, fed)
    calib = fit_calibration(eng, data.valid_x.numpy(), data.valid_m.numpy(),
                            percentile=90.0)
    jcalib = jax_fit_calibration(_jax_engine(model_type, fed),
                                 np.asarray(jdata.valid_x),
                                 np.asarray(jdata.valid_m), percentile=90.0)
    np.testing.assert_allclose(calib.thresholds, jcalib.thresholds,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(calib.count, jcalib.count)
    path = calib.save(str(tmp_path / "calibration.json"))
    back = ServingCalibration.load(path)
    np.testing.assert_array_equal(back.thresholds, calib.thresholds)
    refit = back.refit(1, np.array([1.0, 2.0, 3.0, 4.0]))
    assert refit.count[1] == 4 and refit.thresholds[1] == np.percentile(
        [1.0, 2.0, 3.0, 4.0], 90.0)
    np.testing.assert_array_equal(refit.thresholds[[0, 2]],
                                  back.thresholds[[0, 2]])

    clock = iter(np.arange(0, 100, 1e-4)).__next__
    batcher = MicroBatcher(eng, max_batch=8, max_wait_ms=1.0,
                           calibration=calib, clock=clock)
    test_x = data.test_x.numpy()
    tickets, gws = [], []
    for r in range(20):
        for g in range(N):
            tickets.append(batcher.submit(test_x[g, r], g))
            gws.append(g)
    batcher.drain()
    assert all(t.done for t in tickets)
    scores = np.array([t.score for t in tickets])
    thr = jcalib.thresholds[np.array(gws)]
    away = np.abs(scores - thr) > 1e-4 * np.maximum(1.0, np.abs(thr))
    verdicts = np.array([t.verdict for t in tickets])
    np.testing.assert_array_equal(verdicts[away], (scores > thr)[away])
    assert batcher.stats()["rows_served"] == len(tickets)


def test_roster_swap_and_candidate_state(fed):
    data, _, params = fed
    eng = _port_engine("hybrid", fed)
    rows = data.test_x[0, :6].numpy()
    before = eng.score(rows, 0)
    roster = ServingRoster(member=np.array([True, False, True]),
                           generation=np.array([0, 1, 0]))
    eng.swap_state(roster=roster)
    with pytest.raises(UnknownGatewayError):
        eng.score(rows, 1)
    np.testing.assert_array_equal(eng.score(rows, 0), before)

    scaled = {c: {n: {k: v * (0.5 if k == "kernel" else 1.0)
                      for k, v in layer.items()}
                  for n, layer in coder.items()}
              for c, coder in params["hybrid"].items()}
    cand = eng.candidate_state(params=scaled)
    changed = eng.score_candidate(cand, rows, 0)
    assert not np.allclose(changed, before)
    np.testing.assert_array_equal(eng.score(rows, 0), before)  # not installed
    out = eng.swap_state(params=scaled)
    assert out["swapped"] == ["params"]
    np.testing.assert_array_equal(eng.score(rows, 0), changed)
    with pytest.raises(ValueError, match="does not match"):
        eng.swap_state(params=jax.tree.map(lambda t: t[:2], params["hybrid"]))


def test_engine_refuses_what_waits_for_later_slices(fed):
    """A mesh must be a parallel.ClientMesh; kNN serving refuses only a
    missing bank."""
    _, model = _models("autoencoder")
    with pytest.raises(ValueError, match="banks"):
        ServingEngine(model, "autoencoder", fed[2]["autoencoder"],
                      score_kind="knn", device="cpu")
    with pytest.raises(ValueError, match="train rows"):
        ServingEngine.from_federation(model, "autoencoder",
                                      fed[2]["autoencoder"],
                                      score_kind="knn", device="cpu")
    with pytest.raises(ValueError, match="ClientMesh"):
        _port_engine("autoencoder", fed, mesh=object())
    with pytest.raises(ValueError, match="unknown metric"):
        make_evaluate_all(model, "autoencoder", metric="latency")
    with pytest.raises(ValueError, match="gateway_ids"):
        _port_engine("autoencoder", fed).score(np.zeros((2, DIM)))
