"""The port's host utilities against the JAX package's (tests/test_aux.py's
cases): utils/similarity.py (the KDE similarity score within rel 1e-6,
the Gaussian and mixture divergences within rel 1e-9), visualization.py
(the plots where matplotlib and sklearn are installed, an ImportError
naming the package where not), utils/platform.py `capture_provenance` and
utils/profiling.py (`PhaseTimer`, `trace`, a profiled per-phase round's
`engine.timer`)."""

import json
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

from fedmse_tpu.utils import similarity as ref_sim
from fedmse_tpu_torch.utils import similarity as sim

torch.set_num_threads(1)


# ---- similarity ---- #

@pytest.mark.parametrize("n, d", [(80, 3), (200, 7), (37, 1)])
def test_similarity_score_matches_reference(n, d):
    from sklearn.neighbors import KernelDensity
    rng = np.random.default_rng(n + d)
    a = rng.normal(size=(n, d))
    b = rng.normal(0.5, 1.2, size=(n, d))
    dev_scores = KernelDensity(kernel="gaussian",
                               bandwidth="scott").fit(a).score_samples(a)
    np.testing.assert_allclose(sim.kde_score_samples(a), dev_scores,
                               rtol=1e-9, atol=1e-12)
    got = sim.similarity_score(dev_scores, b)
    assert got == pytest.approx(ref_sim.similarity_score(dev_scores, b),
                                rel=1e-6)


def test_kde_scores_in_blocks():
    from sklearn.neighbors import KernelDensity
    data = np.random.default_rng(3).normal(size=(300, 4))
    want = KernelDensity(kernel="gaussian",
                         bandwidth="scott").fit(data).score_samples(data)
    np.testing.assert_allclose(sim.kde_score_samples(data, block=16), want,
                               rtol=1e-9)


def _spd(rng, k, scale=1.0):
    a = rng.normal(size=(k, k))
    return scale * (a @ a.T / k + 0.5 * np.eye(k))


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_divergences_match_reference(seed):
    rng = np.random.default_rng(seed)
    k = 3 + seed
    pm, qm = rng.normal(size=k), rng.normal(size=k)
    pc, qc = _spd(rng, k), _spd(rng, k, 2.0)
    for fn in ("kl_divergence", "js_divergence"):
        got = getattr(sim, fn)(pm, pc, qm, qc)
        assert got == pytest.approx(getattr(ref_sim, fn)(pm, pc, qm, qc),
                                    rel=1e-9)
    assert sim.kl_divergence(pm, pc, pm, pc) == pytest.approx(0.0,
                                                              abs=1e-9)
    assert sim.js_divergence(pm, pc, qm, qc) == pytest.approx(
        sim.js_divergence(qm, qc, pm, pc), rel=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_mixture_divergences_match_reference(seed):
    rng = np.random.default_rng(10 + seed)
    k, a, b = 4, 3, 2

    def mixture(n):
        w = rng.random(n)
        w[0] = 0.0 if seed == 2 else w[0]  # a zero-weight component
        return (w / w.sum(), rng.normal(size=(n, k)),
                np.stack([_spd(rng, k) for _ in range(n)]))

    p, q = mixture(a), mixture(b)
    for fn in ("gmm_kl_variational", "gmm_js"):
        got = getattr(sim, fn)(*p, *q)
        assert got == pytest.approx(getattr(ref_sim, fn)(*p, *q), rel=1e-9)


# ---- visualization ---- #

def _results_tree(root, combos=(("hybrid", "avg"), ("hybrid", "mse_avg"))):
    rdir = root / "Run_0" / "AUC"
    rdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for mt, ut in combos:
        with open(rdir / f"FL-IoT_0.5_{mt}_{ut}_results.json", "w") as f:
            for rnd in range(3):
                metrics = list(rng.random(4) * 0.1 + 0.9)
                metrics[3] = None if rnd == 2 else metrics[3]  # retired
                json.dump({"round": rnd + 1, "client_metrics": metrics,
                           "update_type": ut, "model_type": mt,
                           "global_loss": 0.9}, f)
                f.write("\n")
    (rdir / "verification_results.json").write_text("[]\n")


def test_load_round_results_matches_reference(tmp_path):
    from fedmse_tpu.visualization import load_round_results as ref_load
    from fedmse_tpu_torch.visualization import load_round_results
    _results_tree(tmp_path)
    got = load_round_results(str(tmp_path))
    assert got == ref_load(str(tmp_path))
    assert sorted(got) == ["FL-IoT_0.5_hybrid_avg",
                           "FL-IoT_0.5_hybrid_mse_avg"]


def test_plot_results_and_latents(tmp_path):
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.visualization import (main, plot_latent_tsne,
                                                plot_results,
                                                save_latent_data)
    _results_tree(tmp_path)
    out = plot_results(str(tmp_path), str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in out] == [
        "per_gateway_metrics.png", "round_curves.png"]
    assert all(os.path.getsize(p) > 0 for p in out)
    assert plot_results(str(tmp_path / "empty"), str(tmp_path / "p2")) == []

    rng = np.random.default_rng(0)
    lat = np.concatenate([rng.normal(0, 1, (60, 7)),
                          rng.normal(4, 1, (40, 7))])
    lab = np.concatenate([np.zeros(60), np.ones(40)])
    writer = ResultsWriter(str(tmp_path / "ckpt"), 4, "exp", "scen", "AUC",
                           0.5)
    p = save_latent_data(writer, 0, "avg", lat, lab)
    with open(p, "rb") as f:
        l2, _ = pickle.load(f)
    assert l2.shape == (100, 7)
    png = plot_latent_tsne([p], str(tmp_path / "tsne.png"), max_points=80)
    assert os.path.getsize(png) > 0
    written = main(["--results-dir", str(tmp_path), "--out",
                    str(tmp_path / "cli"), "--latent-glob",
                    os.path.join(os.path.dirname(p), "*.pkl")])
    assert [os.path.basename(w) for w in written] == [
        "per_gateway_metrics.png", "round_curves.png", "latent_tsne.png"]


@pytest.mark.parametrize("missing, package", [
    ("matplotlib", "matplotlib"), ("sklearn", "scikit-learn")])
def test_plots_name_a_missing_package(tmp_path, monkeypatch, missing,
                                      package):
    """The card's machine has neither package: a plot raises ImportError
    naming it (pickle writing and result loading need neither)."""
    from fedmse_tpu_torch import visualization as viz
    for name in list(sys.modules):
        if name == missing or name.startswith(missing + "."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, missing, None)
    _results_tree(tmp_path)
    with pytest.raises(ImportError, match=f"needs {package}"):
        if missing == "matplotlib":
            viz.plot_results(str(tmp_path), str(tmp_path / "plots"))
        else:
            viz.plot_latent_tsne(["unused.pkl"], str(tmp_path / "t.png"))
    assert viz.load_round_results(str(tmp_path))


# ---- provenance ---- #

def test_capture_provenance_identifies_the_commit(tmp_path):
    from fedmse_tpu_torch.utils import platform as plat
    out = plat.capture_provenance()
    assert set(out) == {"git_commit", "git_dirty", "captured_utc"}
    assert out["git_commit"] and all(c in "0123456789abcdef"
                                     for c in out["git_commit"])
    assert isinstance(out["git_dirty"], bool)
    assert len(out["captured_utc"]) == 20 and out["captured_utc"][-1] == "Z"
    # an artifact JSON written at the repo root leaves the code clean
    probe = os.path.join(plat.REPO, "BENCH_TORCH_PROVENANCE_SCRATCH.json")
    saved = plat._GIT_SNAPSHOT
    try:
        with open(probe, "w") as f:
            f.write("{}")
        plat._GIT_SNAPSHOT = None
        assert plat.capture_provenance()["git_dirty"] == out["git_dirty"]
    finally:
        plat._GIT_SNAPSHOT = saved
        os.remove(probe)


def test_capture_provenance_pins_git_at_first_success():
    from unittest import mock
    from fedmse_tpu_torch.utils import platform as plat
    plat.capture_provenance()
    saved = plat._GIT_SNAPSHOT
    try:
        plat._GIT_SNAPSHOT = {"git_commit": "deadbeef-sentinel",
                              "git_dirty": "sentinel"}
        again = plat.capture_provenance()
        assert again["git_commit"] == "deadbeef-sentinel"
        assert len(again["captured_utc"]) == 20
        plat._GIT_SNAPSHOT = None
        with mock.patch("subprocess.run", side_effect=OSError("git gone")):
            nulled = plat.capture_provenance()
        assert nulled["git_commit"] is None and nulled["git_dirty"] is None
        assert plat._GIT_SNAPSHOT is None  # a failure is not pinned
        assert plat.capture_provenance()["git_commit"]
        assert plat._GIT_SNAPSHOT is not None
    finally:
        plat._GIT_SNAPSHOT = saved


# ---- profiling ---- #

def test_phase_timer_accumulates():
    from fedmse_tpu_torch.utils.profiling import PhaseTimer
    t = PhaseTimer(enabled=True, device="cpu")
    for _ in range(2):
        with t.phase("a"):
            time.sleep(0.01)
    with t.phase("b"):
        pass
    assert t.timings()["a"] >= 0.02
    assert set(t.timings()) == {"a", "b"}
    t.reset()
    assert t.timings() == {}
    off = PhaseTimer(enabled=False)
    with off.phase("x"):
        pass
    assert off.timings() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    from fedmse_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_round_engine_phase_timings_accumulate():
    """A profiled per-phase round: engine.timer holds train, vote and
    evaluate, summed over rounds, and each round's phase_seconds is its
    own share."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                       synthetic_clients)
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(dim_features=8, network_size=3, epochs=1,
                           batch_size=8)
    clients = synthetic_clients(n_clients=3, dim=8, n_normal=60,
                                n_abnormal=20)
    rngs = ExperimentRngs(run=0)
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         8, device="cpu")
    eng = RoundEngine(make_model("hybrid", 8, shrink_lambda=1.0,
                                 device="cpu"), cfg, data, n_real=3,
                      rngs=rngs, model_type="hybrid", update_type="avg",
                      profile=True)
    first = eng.run_round(0).phase_seconds
    after_one = eng.timer.timings()
    assert {"train", "vote", "evaluate"} <= set(after_one)
    assert all(v >= 0 for v in after_one.values())
    assert first == after_one
    second = eng.run_round(1).phase_seconds
    total = eng.timer.timings()
    for k, v in second.items():
        assert total[k] == pytest.approx(after_one.get(k, 0.0) + v)
    assert total["train"] > after_one["train"]
