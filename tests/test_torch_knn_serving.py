"""kNN serving in the port (fedmse_tpu_torch/serving with score_kind 'knn'):
the engine against the port's evaluator oracle and the JAX engine, bank hot
swap, the continuous front with a mid-stream bank swap, the drift monitor
against the JAX one, and the CLI's --serve pass.

Tolerances: served scores 1e-5 against the evaluator oracle (the same
kernels' twins on the same rows); against the JAX engine rtol 1e-4, atol
1e-5 (the JAX package's kNN tolerance). Drift reports agree to 1e-12
(the same float64 numpy arithmetic).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.knn import build_banks as jax_build_banks
from fedmse_tpu.models import init_stacked_params as jax_init_params
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.serving import DriftMonitor as JaxDrift
from fedmse_tpu.serving import ServingCalibration as JaxCalibration
from fedmse_tpu.serving import ServingEngine as JaxEngine
from fedmse_tpu.serving.smoke import \
    interleave_test_rows as jax_interleave_test_rows
from fedmse_tpu_torch.config import DatasetConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.knn import ReferenceBank, build_banks, load_bank
from fedmse_tpu_torch.main import main as port_main
from fedmse_tpu_torch.models import make_model, params_from_numpy
from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                      MicroBatcher, ServingCalibration,
                                      ServingEngine, fit_calibration,
                                      interleave_order, interleave_test_rows)

torch.set_num_threads(1)

DIM, N, BATCH = 12, 3, 12
KNN = dict(knn_bank_size=32, knn_k=4)


@pytest.fixture(scope="module")
def fed():
    """Port data and JAX-initialized params for both model types."""
    clients = synthetic_clients(n_clients=N, dim=DIM, n_normal=150,
                                n_abnormal=40, seed=5)
    data = stack_clients(clients, np.zeros((4, DIM), np.float32), BATCH,
                         device="cpu")
    params = {}
    for mt in ("autoencoder", "hybrid"):
        jm = jax_make_model(mt, DIM, shrink_lambda=1.0)
        params[mt] = jax.tree.map(np.asarray,
                                  jax_init_params(jm, jax.random.key(11), N))
    return data, params


def _model(mt):
    return make_model(mt, DIM, shrink_lambda=1.0, device="cpu")


def _engine(mt, fed, topk="approx", **kw):
    data, params = fed
    return ServingEngine.from_federation(
        _model(mt), mt, params[mt], data.train_xb, data.train_mb,
        score_kind="knn", knn_topk=topk, max_bucket=8, device="cpu",
        **KNN, **kw)


def _oracle(mt, fed, topk):
    data, params = fed
    return make_evaluate_all(
        _model(mt), mt, metric="scores", score_kind="knn", knn_topk=topk,
        **KNN)(params_from_numpy(params[mt], device="cpu"), data.test_x,
               data.test_m, data.test_y, data.train_xb,
               data.train_mb).numpy()


@pytest.mark.parametrize("topk", ["exact", "approx"])
@pytest.mark.parametrize("routing", ["gather", "dense", "single"])
def test_knn_engine_matches_evaluator_oracle(routing, topk, fed):
    """Served kNN scores equal the evaluator's at every bucket size; the
    single-tenant engine scores one gateway's model against its bank."""
    mt = "hybrid" if routing == "dense" else "autoencoder"
    oracle = _oracle(mt, fed, topk)
    data, params = fed
    test_x = data.test_x.numpy()
    if routing == "single":
        g = 2
        full = _engine(mt, fed, topk)
        bank = ReferenceBank(full.banks.latents[g:g + 1],
                             full.banks.count[g:g + 1])
        eng = ServingEngine(_model(mt), mt,
                            jax.tree.map(lambda t: t[g], params[mt]),
                            banks=bank, score_kind="knn", knn_k=4,
                            knn_topk=topk, multi_tenant=False, max_bucket=8,
                            device="cpu")
        gws, rows, want = None, test_x[g, :19], oracle[g, :19]
    else:
        eng = _engine(mt, fed, topk, routing=routing)
        gws = np.random.default_rng(0).integers(0, N, 19).astype(np.int32)
        rows = test_x[gws, np.arange(19)]
        want = oracle[gws, np.arange(19)]
    for n in (1, 2, 3, 5, 8, 19):
        got = eng.score(rows[:n], None if gws is None else gws[:n])
        np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{routing} n={n}")
    assert sorted(eng.dispatches) == [1, 2, 4, 8]


@pytest.mark.parametrize("topk", ["exact", "approx"])
def test_knn_engine_matches_jax_engine_on_a_jax_bank(topk, fed):
    data, params = fed
    jm = jax_make_model("hybrid", DIM, shrink_lambda=1.0)
    train = data.train_xb.numpy()
    mask = data.train_mb.numpy()
    jbank = jax_build_banks(jm, params["hybrid"], train, mask, bank_size=64)
    jeng = JaxEngine(jm, "hybrid", params["hybrid"], banks=jbank,
                     score_kind="knn", knn_k=8, knn_topk=topk, max_bucket=16,
                     bucket_ladder="pow2")
    bank = ReferenceBank(torch.from_numpy(np.array(jbank.latents)),
                         torch.from_numpy(np.array(jbank.count)))
    eng = ServingEngine(_model("hybrid"), "hybrid", params["hybrid"],
                        banks=bank, score_kind="knn", knn_k=8,
                        knn_topk=topk, max_bucket=16, device="cpu")
    rng = np.random.default_rng(1)
    gws = rng.integers(0, N, 40).astype(np.int32)
    rows = data.test_x.numpy()[gws, rng.integers(0, 30, 40)]
    np.testing.assert_allclose(eng.score(rows, gws), jeng.score(rows, gws),
                               rtol=1e-4, atol=1e-5)


def test_bank_swap_state_and_gateway_checks(fed):
    data, params = fed
    eng = _engine("autoencoder", fed)
    rows = data.test_x[1, :6].numpy()
    before = eng.score(rows, 1)
    model = _model("autoencoder")
    tparams = params_from_numpy(params["autoencoder"], device="cpu")
    bigger = build_banks(model, tparams, data.train_xb, data.train_mb,
                         bank_size=64, seed=9)
    fresh = ServingEngine(model, "autoencoder", params["autoencoder"],
                          banks=bigger, score_kind="knn", knn_k=4,
                          knn_topk="approx", max_bucket=8, device="cpu")
    cand = eng.candidate_state(banks=bigger)  # scored, not installed
    np.testing.assert_array_equal(eng.score_candidate(cand, rows, 1),
                                  fresh.score(rows, 1))
    np.testing.assert_array_equal(eng.score(rows, 1), before)
    out = eng.swap_state(banks=bigger)  # capacity 32 -> 64 is allowed
    assert out["swapped"] == ["banks"] and eng.banks.bank_size == 64
    np.testing.assert_array_equal(eng.score(rows, 1), fresh.score(rows, 1))
    wrong_n = ReferenceBank(bigger.latents[:2], bigger.count[:2])
    with pytest.raises(ValueError, match="gateways"):
        eng.swap_state(banks=wrong_n)
    with pytest.raises(ValueError, match="latent_dim"):
        eng.swap_state(banks=ReferenceBank(bigger.latents[..., :3],
                                           bigger.count))
    with pytest.raises(ValueError, match="different federation"):
        ServingEngine(model, "autoencoder", params["autoencoder"],
                      banks=wrong_n, score_kind="knn", device="cpu")
    mse = ServingEngine(model, "autoencoder", params["autoencoder"],
                        device="cpu")
    with pytest.raises(ValueError, match="without kNN banks"):
        mse.swap_state(banks=bigger)


def test_continuous_front_mid_stream_bank_swap(fed):
    """A refreshed bank (build_banks(existing=...)) swaps in between
    dispatches: the in-flight batch keeps the old bank, later batches use
    the new one, no ticket is dropped or scored twice, and every score is
    the micro-batcher's under the same bank. An intake tap sees every
    harvested batch once."""
    data, params = fed
    eng = _engine("hybrid", fed)
    model = _model("hybrid")
    tparams = params_from_numpy(params["hybrid"], device="cpu")
    old_bank = eng.banks
    new_x = np.random.default_rng(2).normal(
        0.5, 1.0, size=(N, 40, DIM)).astype(np.float32)
    refreshed = build_banks(model, tparams, new_x, existing=old_bank, seed=7)
    calib = fit_calibration(eng, data.valid_x.numpy(), data.valid_m.numpy())
    rng = np.random.default_rng(3)
    gws = rng.integers(0, N, 48).astype(np.int32)
    rows = data.test_x.numpy()[gws, rng.integers(0, 30, 48)]

    def sync_scores(bank, lo, hi):
        e = ServingEngine(model, "hybrid", params["hybrid"], banks=bank,
                          score_kind="knn", knn_k=4, knn_topk="approx",
                          max_bucket=8, device="cpu")
        mb = MicroBatcher(e, max_batch=8, max_wait_ms=1e9)
        tks = [mb.submit(rows[i], gws[i]) for i in range(lo, hi)]
        mb.drain()
        return np.array([t.score for t in tks])

    drift = DriftMonitor(calib)
    front = ContinuousBatcher(eng, max_batch=8, latency_budget_ms=1e9,
                              calibration=calib, drift=drift)
    pre = [front.submit(rows[i], gws[i]) for i in range(16)]
    assert front.in_flight_rows == 8  # rows 8..15 are in flight
    event = front.swap(banks=refreshed)
    post = [front.submit(rows[i], gws[i]) for i in range(16, 48)]
    front.drain()
    assert event["kinds"] == ["banks"]
    st = front.stats()
    assert st["rows_served"] == st["rows_submitted"] == 48
    assert sum(front.dispatch_batch_sizes) == 48  # nothing scored twice
    assert all(t.done for t in pre + post)
    np.testing.assert_array_equal([t.score for t in pre],
                                  sync_scores(old_bank, 0, 16))
    np.testing.assert_array_equal([t.score for t in post],
                                  sync_scores(refreshed, 16, 48))
    assert drift.updates == st["dispatches"]
    verdicts = calib.verdicts(np.array([t.score for t in pre]), gws[:16])
    assert [t.verdict for t in pre] == verdicts.tolist()
    # an intake tap sees each harvested batch once: its rows, gateways,
    # scores and verdicts, in submission order
    seen = []
    tapped = ContinuousBatcher(eng, max_batch=8, latency_budget_ms=1e9,
                               calibration=calib,
                               intake=lambda *a: seen.append(a))
    tks = [tapped.submit(rows[i], gws[i]) for i in range(16)]
    tapped.drain()
    got = [np.concatenate([a[i] for a in seen]) for i in range(4)]
    np.testing.assert_array_equal(got[0], rows[:16])
    np.testing.assert_array_equal(got[1], gws[:16])
    np.testing.assert_array_equal(got[2], [t.score for t in tks])
    assert got[3].tolist() == [t.verdict for t in tks]
    assert len(seen) == tapped.stats()["dispatches"] == 2


@pytest.mark.parametrize("max_rows", [7, 1 << 30])
def test_interleaved_stream_matches_jax(max_rows):
    """The arrival stream (ragged per-gateway masks) is JAX's row for row,
    and interleave_order indexes the same rows."""
    rng = np.random.default_rng(6)
    test_x = rng.normal(size=(4, 9, 3)).astype(np.float32)
    test_m = (rng.random((4, 9)) < 0.6).astype(np.float32)
    test_y = (rng.random((4, 9)) < 0.3).astype(np.float32)
    ours = interleave_test_rows(test_x, test_m, test_y, max_rows)
    theirs = jax_interleave_test_rows(test_x, test_m, test_y, max_rows)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    g, r = interleave_order(test_m, max_rows)
    np.testing.assert_array_equal(test_x[g, r], theirs[0])
    np.testing.assert_array_equal(g, theirs[1])


def test_drift_monitor_matches_jax():
    rng = np.random.default_rng(4)
    fields = dict(percentile=95.0, thresholds=rng.random(4) + 1.0,
                  mean=rng.random(4), std=rng.random(4) * 0.2,
                  count=np.array([50, 40, 0, 30]))
    ours = DriftMonitor(ServingCalibration(**fields), min_count=10,
                        min_batches=2, cooldown_updates=1)
    theirs = JaxDrift(JaxCalibration(**fields), min_count=10, min_batches=2,
                      cooldown_updates=1)
    for step in range(6):
        gws = rng.integers(0, 4, 40)
        scores = rng.normal(0.5 + 0.3 * step, 0.3, 40)
        ours.update(scores, gws)
        theirs.update(scores, gws)
        if step == 3:
            refit = dict(fields, mean=fields["mean"] + 1.0)
            ours.rebaseline(ServingCalibration(**refit))
            theirs.rebaseline(JaxCalibration(**refit))
        a, b = ours.report(), theirs.report()
        assert a.keys() == b.keys()
        for key in ("drifted_gateways", "swap_recommended_gateways",
                    "updates", "last_rebaseline"):
            assert a[key] == b[key], (step, key)
        for ga, gb in zip(a["gateways"], b["gateways"]):
            for key, va in ga.items():
                if isinstance(va, float):
                    assert va == pytest.approx(gb[key], rel=1e-12,
                                               abs=1e-12)
                else:
                    assert va == gb[key], (step, key)
    assert a["swap_recommended_gateways"] or a["drifted_gateways"]


@pytest.mark.parametrize("front", ["sync", "continuous"])
def test_cli_score_kind_knn_serve(front, tmp_path):
    """python -m fedmse_tpu_torch.main --device cpu --score-kind knn
    --serve [--serve-continuous]: the bank npz and the calibration JSON are
    written beside the checkpoint and the report is the kNN one."""
    from tests.test_data import _write_client_csvs

    root = str(tmp_path / "shards")
    _write_client_csvs(root, 4, dim=6, n_normal=60, n_abnormal=24)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(DatasetConfig.for_client_dirs(root, 4).to_json(), f)
    args = ["--device", "cpu", "--dataset-config", cfg_path,
            "--model-types", "hybrid", "--update-types", "mse_avg",
            "--network-size", "4", "--dim-features", "6", "--epochs", "1",
            "--num-rounds", "1", "--batch-size", "8",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--score-kind", "knn", "--knn-bank-size", "16", "--knn-k", "3",
            "--serve", "--serve-rows", "128", "--serve-warmup"]
    if front == "continuous":
        args.append("--serve-continuous")
    out = port_main(args)
    smoke = out["serve_smoke"]
    assert smoke["score_kind"] == "knn" and smoke["front"] == front
    assert smoke["rows"] > 0
    assert smoke["batcher"]["rows_served"] == smoke["rows"]
    bank = load_bank(smoke["knn_bank_path"], device="cpu")
    assert bank.num_gateways == 4 and bank.bank_size == 16
    assert os.path.exists(smoke["calibration_path"])
    assert len(smoke["drift"]["gateways"]) == 4
    json.dumps(smoke)
    if front == "sync":  # --no-save has no checkpoint to serve: skipped
        out = port_main(args + ["--no-save"])
        assert "serve_smoke" not in out
