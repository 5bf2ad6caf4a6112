"""The port's round engine and driver (fedmse_tpu_torch/federation/rounds.py,
fedmse_tpu_torch/main.py) against the JAX package's.

  * RoundEngine vs the JAX per-phase RoundEngine (fused=False) from ONE
    init (the JAX init exported as numpy), vote tie-breaks off: the
    selections, aggregators, verification rows and rejected counters are
    equal; params agree to 1e-4 scale-normalized per leaf after 3 rounds
    (summation order compounded over the rounds' Adam steps) and per-client
    AUC to 2e-3.
  * The quick-run sweep through both drivers on the same CSV shards: the
    same artifact tree (relative paths) and file formats, every final AUC
    finite. The drivers start from their own inits (jax.random vs
    torch.Generator), so the numbers are not compared here.
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import DatasetConfig as JaxDataset
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.federation import RoundEngine as JaxEngine
from fedmse_tpu.main import GlobalEarlyStop as JaxEarlyStop
from fedmse_tpu.main import main as jax_main
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.federation import RoundEngine, client_states_from_numpy
from fedmse_tpu_torch.main import GlobalEarlyStop
from fedmse_tpu_torch.main import main as port_main
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.test_data import _write_client_csvs

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)


def _flat(tree):
    return LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)), tree))


@pytest.mark.parametrize("model_type,update_type,hardened", [
    ("hybrid", "mse_avg", False), ("autoencoder", "fedprox", False),
    ("hybrid", "avg", True)])
def test_round_engine_matches_jax_per_phase(model_type, update_type,
                                            hardened):
    kw = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=4,
              hardened_verification=hardened)
    jcfg = JaxConfig(**kw, compat=JaxCompat(vote_tie_break=False))
    tcfg = ExperimentConfig(**kw, compat=CompatConfig(vote_tie_break=False))
    data_kw = dict(n_clients=4, dim=16, n_normal=240, n_abnormal=120, seed=0)
    tclients, jclients = synthetic_clients(**data_kw), jax_synthetic(**data_kw)
    dev_x = np.concatenate([c.dev_raw for c in tclients])[:200].astype(
        np.float32)
    jm = jax_make_model(model_type, *DIMS, jcfg.shrink_lambda)
    tm = make_model(model_type, *DIMS, tcfg.shrink_lambda, device="cpu")
    jeng = JaxEngine(jm, jcfg, jax_stack(jclients, dev_x, 12), n_real=4,
                     rngs=JaxRngs(run=0), model_type=model_type,
                     update_type=update_type, fused=False)
    init = client_states_from_numpy(
        jax.tree.map(np.array, jeng.states), LAYOUT, device="cpu")
    teng = RoundEngine(tm, tcfg, stack_clients(tclients, dev_x, 12,
                                               device="cpu"),
                       n_real=4, rngs=ExperimentRngs(run=0),
                       model_type=model_type, update_type=update_type,
                       states=init)
    for r in range(3):
        want, got = jeng.run_round(r), teng.run_round(r)
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        np.testing.assert_array_equal(
            teng.states.rejected.numpy(), np.asarray(jeng.states.rejected))
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        np.testing.assert_allclose(got.tracking, want.tracking, rtol=1e-4,
                                   atol=1e-6)
    want_p = _flat(jeng.states.params)
    for sl in LAYOUT.slices():
        err = (teng.states.params[:, sl] - want_p[:, sl]).abs().max()
        assert float(err) <= 1e-4 * float(want_p[:, sl].abs().max())
    np.testing.assert_array_equal(teng.host.aggregation_count,
                                  jeng.host.aggregation_count)


def test_reset_federation_replays_the_same_rounds():
    """reset_federation restarts the random streams, the port's own init
    and the host counters: the same rounds follow, bit for bit."""
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=4, epochs=2)
    clients = synthetic_clients(n_clients=4, dim=16, n_normal=120,
                                n_abnormal=40, seed=1)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:60].astype(
        np.float32)
    eng = RoundEngine(make_model("hybrid", *DIMS, cfg.shrink_lambda,
                                 device="cpu"), cfg,
                      stack_clients(clients, dev_x, 12, device="cpu"),
                      n_real=4, rngs=ExperimentRngs(run=1),
                      model_type="hybrid", update_type="mse_avg")
    runs = []
    for _ in range(2):
        rounds = [eng.run_round(r) for r in range(2)]
        runs.append(([(r.selected, r.aggregator) for r in rounds],
                     eng.states.params.clone(),
                     eng.host.aggregation_count.copy()))
        eng.reset_federation()
    (sel_a, p_a, agg_a), (sel_b, p_b, agg_b) = runs
    assert sel_a == sel_b and agg_a.sum() > 0
    torch.testing.assert_close(p_a, p_b, rtol=0, atol=0)
    np.testing.assert_array_equal(agg_a, agg_b)


def test_global_early_stop_matches_jax():
    seq = [np.array(v) for v in ([0.9, 0.8], [0.7, 0.95], [0.85, 0.9],
                                 [0.6, np.nan], [0.99, 0.99])]
    for inverted in (True, False):
        a, b = JaxEarlyStop(inverted=inverted), GlobalEarlyStop(
            inverted=inverted)
        assert [a.should_stop(m) for m in seq] == \
            [b.should_stop(m) for m in seq]


def test_latency_metric_times_every_client():
    clients = synthetic_clients(n_clients=3, dim=8, n_normal=60,
                                n_abnormal=20, seed=1)
    data = stack_clients(clients, np.zeros((1, 8), np.float32), 12,
                         device="cpu")
    for model_type in ("autoencoder", "hybrid"):
        model = make_model(model_type, 8, 4, 2, device="cpu")
        small = ParamLayout(8, 4, 2)
        params = small.tree(torch.randn(3, small.size) * 0.3)
        lat = make_evaluate_all(model, model_type, metric="time",
                                latency_reps=2)(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb)
        assert lat.shape == (3,) and bool(torch.all(lat > 0))


def _tree(root):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def _shape(path):
    """What a file's format is: JSON-line keys, npz keys and shapes, the
    pickle's structure."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return sorted((k, z[k].shape) for k in z.files)
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".pkl"):
        obj = pickle.loads(raw)
        if isinstance(obj, tuple):
            return ("tuple", [np.asarray(o).ndim for o in obj])
        return ("list", sorted({len(r) for r in obj}))
    if path.endswith("training_summary.json"):
        doc = json.loads(raw)
        return sorted(doc), sorted(doc["results"]), sorted(
            doc["results"]["hybrid/avg/run0"])
    return [sorted(json.loads(line)) for line in raw.splitlines()][:1]


def test_quick_run_sweep_artifacts_match_jax_driver(tmp_path):
    dim = 6
    shards = tmp_path / "shards"
    _write_client_csvs(str(shards), 4, dim=dim, n_normal=80, n_abnormal=30)
    cfg_path = tmp_path / "config.json"
    with open(cfg_path, "w") as f:
        json.dump(JaxDataset.for_client_dirs(str(shards), 4).to_json(), f)
    args = ["--dataset-config", str(cfg_path), "--network-size", "4",
            "--dim-features", str(dim), "--epochs", "2", "--num-rounds", "2",
            "--experiment-name", "t"]
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    jax_main(args + ["--checkpoint-dir", roots["jax"]])
    out = port_main(args + ["--checkpoint-dir", roots["port"],
                            "--device", "cpu"])
    assert _tree(roots["port"]) == _tree(roots["jax"])
    for rel in _tree(roots["jax"]):
        assert _shape(os.path.join(roots["port"], rel)) == \
            _shape(os.path.join(roots["jax"], rel)), rel
    finals = [v for r in out["results"].values() for v in r["final_metrics"]]
    assert len(finals) == 6 * 4 and np.all(np.isfinite(finals))
    assert set(out["best_metrics"]) == {"hybrid", "autoencoder"}
