"""The port's study drivers (cluster_sweep_torch.py,
drift_recovery_sweep_torch.py, paper_check_torch.py,
quirk_ablation_torch.py, parity_probe_torch.py) held against the JAX
drivers, whose functions are called unchanged.

Each pair runs on the same data with the JAX engine's init carried into
the port (`states=`, through client_states_from_numpy), the JAX engine's
membership timeline fed through `elastic_masks=`, and the vote tie-break
off on both sides (the JAX drivers' configs are patched to it where they
build their own). Discrete fields (cluster sizes and assignments,
aggregated rounds, joined slots, rounds_run, swap counts, stop epochs,
each bar's truth value) must be equal; AUC fields agree within 2e-3 and
loss curves within 1e-5; the data generators' draws are bit-equal; the
K = 1 pin is bit-equal on the port's own side. Sizes: width 16 (115 for
the parity probe, whose config is the paper's), 4 to 8 clients, 2 to 10
rounds of 1 to 5 epochs.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import cluster_sweep  # noqa: E402
import cluster_sweep_torch  # noqa: E402
import drift_recovery_sweep  # noqa: E402
import drift_recovery_sweep_torch  # noqa: E402
import paper_check  # noqa: E402
import paper_check_torch  # noqa: E402
import parity_probe  # noqa: E402
import parity_probe_torch  # noqa: E402
import quirk_ablation  # noqa: E402
import quirk_ablation_torch  # noqa: E402
import fedmse_tpu.config as jax_config  # noqa: E402
import fedmse_tpu.federation as jax_federation  # noqa: E402
from fedmse_tpu.cluster import ClusterSpec as JaxClusterSpec  # noqa: E402
from fedmse_tpu.config import CompatConfig as JaxCompat  # noqa: E402
from fedmse_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from fedmse_tpu.data import build_dev_dataset as jax_dev  # noqa: E402
from fedmse_tpu.data import stack_clients as jax_stack  # noqa: E402
from fedmse_tpu.data import synthetic_clients as jax_synthetic  # noqa: E402
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec  # noqa: E402
from fedmse_tpu.federation import RoundEngine as JaxEngine  # noqa: E402
from fedmse_tpu.models import make_model as jax_make_model  # noqa: E402
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs  # noqa: E402
from fedmse_tpu_torch.cluster import ClusterSpec  # noqa: E402
from fedmse_tpu_torch.config import (CompatConfig,  # noqa: E402
                                     ExperimentConfig)
from fedmse_tpu_torch.data import (stack_clients,  # noqa: E402
                                   synthetic_clients)
from fedmse_tpu_torch.federation import client_states_from_numpy  # noqa: E402
from fedmse_tpu_torch.federation.elastic import MembershipMasks  # noqa: E402
from fedmse_tpu_torch.models.flat import ParamLayout  # noqa: E402

torch.set_num_threads(1)

AUC_TOL = 2e-3
LOSS_TOL = 1e-5
WIDTH = 16
NO_TIE = dict(vote_tie_break=False)


def numpy_tree(tree):
    return jax.tree.map(np.array, tree)


def carried(jstates, layout):
    return client_states_from_numpy(jstates, layout, device="cpu")


def port_masks(jmasks):
    return MembershipMasks(*(np.asarray(m) for m in jmasks))


def assert_auc_close(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), atol=AUC_TOL,
                               err_msg=what)


def recorded_inits(mp, module, store):
    """Replace `module.RoundEngine` by one that records the numpy states of
    every fresh federation (at construction and at each reset)."""
    base = module.RoundEngine

    class Recorder(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            store.append(numpy_tree(self.states))

        def reset_federation(self):
            super().reset_federation()
            store.append(numpy_tree(self.states))

    mp.setattr(module, "RoundEngine", Recorder)


def no_tie_configs(mp, **fields):
    """Patch the JAX package's ExperimentConfig, as the drivers import it
    inside their functions, to build with `fields` and the tie-break off."""
    orig = jax_config.ExperimentConfig

    def make(**kw):
        return orig(**{**kw, **fields}, compat=JaxCompat(**NO_TIE))

    mp.setattr(jax_config, "ExperimentConfig", make)


# ---------------------------------------------------------------- draws ----

def test_bulk_typed_federation_is_the_jax_draw():
    """--podscale's typed fleet: every tensor and the generating types
    bit-equal to the JAX driver's `_bulk_typed_federation`."""
    want, want_t = cluster_sweep._bulk_typed_federation(64, 8, 16, 4)
    got, got_t = cluster_sweep_torch.bulk_typed_federation(64, 8, 16, 4)
    np.testing.assert_array_equal(got_t, want_t)
    for name in ("train_xb", "train_mb", "valid_xb", "valid_mb", "valid_x",
                 "valid_m", "test_x", "test_m", "test_y", "dev_x",
                 "client_mask"):
        t = getattr(got, name)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("grid", ["typed", "dirichlet"])
def test_cluster_grids_are_the_jax_grids(grid):
    jcfg = cluster_sweep.base_cfg("mse")
    tcfg = cluster_sweep_torch.base_cfg("mse")
    if grid == "typed":
        want, n_want = cluster_sweep.build_typed_grid(jcfg, 8, 2)
        got, n_got = cluster_sweep_torch.build_typed_grid(tcfg, 8, 2,
                                                          device="cpu")
    else:
        want, n_want = cluster_sweep.build_dirichlet_grid(jcfg, 8)
        got, n_got = cluster_sweep_torch.build_dirichlet_grid(tcfg, 8,
                                                              device="cpu")
    assert n_got == n_want
    for name in ("train_xb", "train_mb", "valid_x", "test_x", "test_y",
                 "dev_x", "client_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed,on_frac,behind", [(0, 0.5, 1.25),
                                                 (3, 1.0, 2.5)])
def test_regime_draws_are_the_jax_draws(seed, on_frac, behind):
    want = drift_recovery_sweep.Regime(seed, on_frac=on_frac, behind=behind)
    got = drift_recovery_sweep_torch.Regime(seed, on_frac=on_frac,
                                            behind=behind)
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.u, want.u)
    for shift in (0.0, 1.5):
        np.testing.assert_array_equal(
            got.normals(np.random.default_rng(5), 40, shift),
            want.normals(np.random.default_rng(5), 40, shift))
        np.testing.assert_array_equal(
            got.anomalies(np.random.default_rng(6), 40, shift),
            want.anomalies(np.random.default_rng(6), 40, shift))


# -------------------------------------------------------------- cluster ----

CLUSTER_KW = dict(network_size=8, num_rounds=4, epochs=2)
CLUSTER_LAYOUT = {"autoencoder": ParamLayout(WIDTH, 12, 5),
                  "hybrid": ParamLayout(WIDTH, 12, 5)}


def cluster_init(jcfg, jdata, n):
    """The init a JAX cluster cell's engine draws (run 0 of the config's
    data seed), carried into the port."""
    mt = cluster_sweep.model_type_for(jcfg.score_kind)
    model = jax_make_model(mt, jcfg.dim_features, jcfg.hidden_neus,
                           jcfg.latent_dim, shrink_lambda=jcfg.shrink_lambda)
    eng = JaxEngine(model, jcfg, jdata, n_real=n,
                    rngs=JaxRngs(run=0, data_seed=jcfg.data_seed),
                    model_type=mt, update_type="mse_avg", fused=True)
    return carried(numpy_tree(eng.states), CLUSTER_LAYOUT[mt]), eng


@pytest.fixture(scope="module")
def cluster_setup():
    jcfg = cluster_sweep.base_cfg("mse").replace(**CLUSTER_KW)
    tcfg = cluster_sweep_torch.base_cfg("mse").replace(**CLUSTER_KW)
    jdata, n = cluster_sweep.build_typed_grid(jcfg, 8, 2)
    tdata, _ = cluster_sweep_torch.build_typed_grid(tcfg, 8, 2,
                                                    device="cpu")
    init, _ = cluster_init(jcfg, jdata, n)
    return jcfg, tcfg, jdata, tdata, n, init


CLUSTER_CELLS = {
    "mse-single": ("mse", None, False),
    "mse-k2": ("mse", 2, False),
    "mse-k1-personalized": ("mse", 1, True),
    "knn-k2": ("knn", 2, False),
    "centroid-k2": ("centroid", 2, False),
}
_CELL_RUNS = {}


def cluster_pair(setup, label):
    """(JAX (row, engine), port (row, engine)) of one cell, run once a
    module."""
    if label not in _CELL_RUNS:
        jcfg, tcfg, jdata, tdata, n, init = setup
        kind, k, personal = CLUSTER_CELLS[label]
        jcfg, tcfg = (jcfg.replace(score_kind=kind),
                      tcfg.replace(score_kind=kind))
        if kind == "centroid":
            init, _ = cluster_init(jcfg, jdata, n)
        jspec = None if k is None else JaxClusterSpec(k=k,
                                                      personalize=personal)
        tspec = None if k is None else ClusterSpec(k=k, personalize=personal)
        _CELL_RUNS[label] = (
            cluster_sweep.run_cell(jcfg, jdata, n, spec=jspec, label=label),
            cluster_sweep_torch.run_cell(tcfg, tdata, n, spec=tspec,
                                         label=label, states=init))
    return _CELL_RUNS[label]


def assert_cluster_rows(got, want):
    for key, w in want.items():
        if key == "sec_per_round":
            continue
        if key in ("auc_mean", "auc_min"):
            assert_auc_close(got[key], w, key)
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("label", list(CLUSTER_CELLS))
def test_cluster_cell_matches_jax(cluster_setup, label):
    (want, jeng), (got, teng) = cluster_pair(cluster_setup, label)
    assert_cluster_rows(got, want)
    if teng.cluster_assignment is not None:
        np.testing.assert_array_equal(teng.cluster_assignment,
                                      np.asarray(jeng.cluster_assignment))
    assert got["sec_per_round"] > 0


def test_cluster_k1_pin_on_the_port(cluster_setup):
    """ClusterSpec(k=1) against no spec from the carried init: the
    ClientStates tensors bit for bit (the JAX driver's pin row)."""
    _, tcfg, _, tdata, n, init = cluster_setup
    pin = cluster_sweep_torch.k1_bitwise_pin(tcfg, tdata, n, states=init)
    assert pin == {"label": "k1_bitwise_pin", "states_bit_identical": True}


def test_padding_invariance_matches_jax():
    """The unpadded and the 12-wide stacking fit the JAX assignments from
    the JAX inits, and both are the same."""
    jcfg = cluster_sweep.base_cfg("mse")
    want = cluster_sweep.padding_invariance(jcfg)
    from fedmse_tpu.data.synthetic import synthetic_typed_clients
    clients = synthetic_typed_clients(n_clients=8, types=2, dim=WIDTH,
                                      n_normal=160, n_abnormal=64, seed=11)
    dev_x = jax_dev(clients, JaxRngs(run=0).data_rng)
    model = jax_make_model("hybrid", WIDTH, jcfg.hidden_neus,
                           jcfg.latent_dim, shrink_lambda=jcfg.shrink_lambda)
    inits = []
    for pad in (None, 12):
        eng = JaxEngine(model, jcfg, jax_stack(clients, dev_x,
                                               jcfg.batch_size,
                                               pad_clients_to=pad),
                        n_real=8, rngs=JaxRngs(run=0), model_type="hybrid",
                        update_type="mse_avg", fused=True)
        inits.append(carried(numpy_tree(eng.states),
                             CLUSTER_LAYOUT["hybrid"]))
    got = cluster_sweep_torch.padding_invariance(
        cluster_sweep_torch.base_cfg("mse"), device="cpu", states=inits)
    assert got == want
    assert got["invariant"] is True


def test_churn_composition_matches_jax(cluster_setup):
    """K = 4 under the leave burst and rejoin wave, the JAX timeline fed
    in: the same joined slots, sizes, aggregated rounds and match rate."""
    jcfg, tcfg, jdata, tdata, n, init = cluster_setup
    jcfg, tcfg = jcfg.replace(epochs=1), tcfg.replace(epochs=1)
    want = cluster_sweep.churn_composition(jcfg, jdata, n)
    spec = cluster_sweep_torch.CHURN_SPEC
    ref = JaxEngine(jax_make_model("autoencoder", WIDTH, jcfg.hidden_neus,
                                   jcfg.latent_dim,
                                   shrink_lambda=jcfg.shrink_lambda),
                    jcfg.replace(num_rounds=10), jdata, n_real=n,
                    rngs=JaxRngs(run=0, data_seed=jcfg.data_seed),
                    model_type="autoencoder", update_type="mse_avg",
                    fused=True, cluster=JaxClusterSpec(k=4),
                    elastic=JaxElasticSpec(**spec))
    got = cluster_sweep_torch.churn_composition(
        tcfg, tdata, n, states=init,
        elastic_masks=port_masks(ref._elastic_masks(0, 10)))
    assert_cluster_rows(got, want)
    assert got["joined_slots"], "the wave recycled no slot"


def test_serving_swap_row_matches_jax(cluster_setup):
    """The K = 2 federation's cluster models installed by a hot swap:
    routing parity and the bucket ladder as in JAX, and on the port no
    library loaded and no launch across the swap on the CPU (the plain
    version runs); each row scored by its gateway's cluster model."""
    (_, jeng), (_, teng) = cluster_pair(cluster_setup, "mse-k2")
    n = cluster_setup[4]
    want = cluster_sweep.serving_zero_retrace(jeng, n)
    got = cluster_sweep_torch.serving_cluster_swap(teng, n)
    for key in ("label", "k", "zero_retrace", "routing_parity",
                "buckets_compiled"):
        assert got[key] == want[key], key
    assert got["libraries_loaded_across_swap"] == 0
    assert got["forward_launches_across_swap"] == 0
    assert got["buckets_dispatched"] == 2
    assert got["routed_to_cluster_model"] is True
    assert got["members_hold_cluster_merge"] == got["routing_parity"]


def test_cluster_quick_cell_on_the_cpu():
    out = cluster_sweep_torch.quick_cell("cpu")
    assert out["k1_bit_identical"] is True
    assert out["acceptance_met"] == bool(out["delta_auc"] >= 0.1)
    assert sum(out["cluster_sizes"]) == 8
    assert out["serving"]["zero_retrace"] is True
    assert out["serving"]["routed_to_cluster_model"] is True


def test_cluster_podscale_on_a_small_tier(tmp_path):
    """--podscale on a 64-gateway tier (CPU): the K = 1 pin on the host
    tier's states, the assignment's purity and the acceptance block."""
    out = tmp_path / "pod.json"
    cluster_sweep_torch.main(["--podscale", "--device", "cpu", "--clients",
                              "64", "--out", str(out)])
    art = json.loads(out.read_text())
    rows = {r["label"]: r for r in art["rows"]}
    assert rows["k1-bitwise-pin-100k"]["states_bit_identical"] is True
    typed = rows["typed-100k-k4-vs-single"]
    assert sum(typed["cluster_sizes"]) == 64
    assert typed["cohort_covered_gateways"] == 64
    acc = art["acceptance"]
    assert acc["purity_met"] == (acc["purity"] >= 0.9)
    assert acc["met"] == bool(acc["k1_bit_identical"] and acc["purity_met"]
                              and acc["delta_met"])
    assert "vote tie-break off" in art["protocol"]
    assert art["device"] == "cpu"


def test_podscale_tier_matches_jax_on_a_sampled_fit():
    """The --podscale federation at 64 gateways, K = 4 fitted on a stride
    sample of 16 gateways (the path the 100k run's 4,096-gateway sample
    takes), from the JAX tier's init: the JAX tier's assignment and
    purity, the final metrics within 2e-3."""
    from fedmse_tpu.federation import TieredRoundEngine as JaxTiered
    from fedmse_tpu.parallel import client_mesh as jax_mesh
    from fedmse_tpu_torch.parallel.mesh import client_mesh
    n, types = 64, cluster_sweep_torch.POD_TYPES
    tcfg = cluster_sweep_torch.podscale_config(n)
    jcfg = JaxConfig(
        dim_features=8, hidden_neus=6, latent_dim=3, network_size=n,
        epochs=2, batch_size=16, num_rounds=6, num_participants=1.0,
        state_layout="tiered", host_sharded=True,
        compat=JaxCompat(shared_last_client_val=False, **NO_TIE))
    jdata, t_of = cluster_sweep._bulk_typed_federation(n, 8, 16, types)
    tdata, _ = cluster_sweep_torch.bulk_typed_federation(n, 8, 16, types)
    jeng = JaxTiered(jax_make_model("hybrid", 8, 6, 3, jcfg.shrink_lambda),
                     jcfg, jdata, n_real=n,
                     rngs=JaxRngs(run=0, data_seed=jcfg.data_seed),
                     model_type="hybrid", update_type="mse_avg",
                     mesh=jax_mesh(), host_sharded=True,
                     cluster=JaxClusterSpec(k=types, fit_sample=16))
    init = carried(numpy_tree(jeng.store.host), ParamLayout(8, 6, 3))
    jeng.run_rounds(0, 6, lambda r, s: False)
    want = np.asarray(jeng.evaluate_final_streamed())
    teng, got, results, _ = cluster_sweep_torch.podscale_run(
        tcfg, tdata, ClusterSpec(k=types, fit_sample=16), 6,
        client_mesh("cpu"), "cpu", states=init)
    assignment = np.asarray(jeng.cluster_assignment)
    np.testing.assert_array_equal(teng.cluster_assignment, assignment)
    assert cluster_sweep_torch.purity(teng.cluster_assignment, t_of,
                                      types) == 1.0
    np.testing.assert_allclose(got, want.reshape(got.shape), atol=AUC_TOL)
    assert len(results) == 6


CLUSTER_ROWS = [
    {"grid": "multimodal", "score_kind": "mse", "k": 1,
     "personalize": False, "auc_mean": 0.5},
    {"grid": "multimodal", "score_kind": "mse", "k": 4,
     "personalize": False, "auc_mean": 0.75},
    {"grid": "multimodal", "score_kind": "centroid", "k": 1,
     "personalize": False, "auc_mean": 0.8},
    {"grid": "multimodal", "score_kind": "centroid", "k": 2,
     "personalize": False, "auc_mean": 0.85},
    {"grid": "multimodal", "score_kind": "knn", "k": 1,
     "personalize": False, "auc_mean": 0.9},
    {"grid": "dirichlet", "score_kind": "knn", "k": 4,
     "personalize": False, "auc_mean": 0.95},
    {"grid": "dirichlet", "score_kind": "knn", "k": 1,
     "personalize": False, "auc_mean": 0.93},
]
CLUSTER_ACCEPTANCE = {
    "all_met": {},
    "pin_broken": {"pin": {"states_bit_identical": False}},
    "no_delta": {"rows": 0.52},
    "padding_moved": {"pad": {"invariant": False}},
    "churn_mismatch": {"churn": {"join_cluster_match_rate": 0.875}},
    "swap_retraced": {"serve": {"zero_retrace": False}},
    "swap_misrouted": {"serve": {"routing_parity": False}},
}


@pytest.mark.parametrize("case", list(CLUSTER_ACCEPTANCE))
def test_cluster_acceptance_matches_jax(case, monkeypatch, tmp_path):
    """The JAX driver's main() with its cells replaced by the same rows and
    pins the port's acceptance_block takes: the same acceptance."""
    edits = CLUSTER_ACCEPTANCE[case]
    rows = [dict(r) for r in CLUSTER_ROWS]
    if "rows" in edits:
        rows[1]["auc_mean"] = edits["rows"]
    pin = {"label": "k1_bitwise_pin", "states_bit_identical": True,
           **edits.get("pin", {})}
    pad = {"label": "padding_invariance", "assignment": [0, 1],
           "invariant": True, **edits.get("pad", {})}
    churn = {"label": "churn_composition", "join_cluster_match_rate": 1.0,
             **edits.get("churn", {})}
    serve = {"label": "serving_cluster_swap", "k": 4, "zero_retrace": True,
             "routing_parity": True, "buckets_compiled": 7,
             **edits.get("serve", {})}
    cells = {(r["grid"], r["score_kind"], r["k"], r["personalize"]): r
             for r in rows}

    def fake_run_cell(cfg, data, n_real, spec=None, elastic=None,
                      label="cell"):
        grid = "dirichlet" if data == "dirichlet" else "multimodal"
        k = 1 if spec is None else spec.k
        personal = bool(spec is not None and spec.personalize)
        row = cells.get((grid, cfg.score_kind, k, personal))
        if row is None:
            row = {"score_kind": cfg.score_kind, "k": k,
                   "personalize": personal, "auc_mean": 0.0}
        return {k_: v for k_, v in row.items() if k_ != "grid"}, None

    monkeypatch.setattr(cluster_sweep, "build_typed_grid",
                        lambda cfg: ("typed", 24))
    monkeypatch.setattr(cluster_sweep, "build_dirichlet_grid",
                        lambda cfg: ("dirichlet", 24))
    monkeypatch.setattr(cluster_sweep, "run_cell", fake_run_cell)
    monkeypatch.setattr(cluster_sweep, "k1_bitwise_pin", lambda *a: pin)
    monkeypatch.setattr(cluster_sweep, "padding_invariance", lambda *a: pad)
    monkeypatch.setattr(cluster_sweep, "churn_composition",
                        lambda *a: churn)
    monkeypatch.setattr(cluster_sweep, "serving_zero_retrace",
                        lambda *a: serve)
    out = tmp_path / "cl.json"
    monkeypatch.setattr(sys, "argv", ["cluster_sweep.py", "--out", str(out)])
    cluster_sweep.main()
    art = json.loads(out.read_text())
    got = cluster_sweep_torch.acceptance_block(art["rows"], pin, pad, churn,
                                               serve)
    want = art["acceptance"]
    assert {k: v for k, v in got.items() if k != "bar"} == \
        {k: v for k, v in want.items() if k != "bar"}
    assert got["met"] == (case == "all_met")


# ---------------------------------------------------------------- drift ----

DRIFT_ROWS = 144  # rows a gateway a stage, from 288


@pytest.fixture(scope="module")
def drift_pair():
    """The (1.5 sigma, mse, 3 stages) cell of both drivers at DRIFT_ROWS
    rows a gateway a stage, the JAX federation's init carried into the
    port, the tie-break off."""
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        for module in (drift_recovery_sweep, drift_recovery_sweep_torch):
            mp.setattr(module, "ROWS_PER_STAGE", DRIFT_ROWS)
        no_tie_configs(mp)
        recorded_inits(mp, jax_federation, inits)
        want = drift_recovery_sweep.run_cell(1.5, "mse", 3)
        got = drift_recovery_sweep_torch.run_cell(
            1.5, "mse", 3, device="cpu",
            states=carried(inits[0], ParamLayout(WIDTH, 27, 7)),
            compat=CompatConfig(**NO_TIE))
    return want, got


DRIFT_EXACT = ("delta_sigma", "stages", "hold_stages", "score_kind",
               "model_type", "anomaly_behind_sigma", "walk_on_manifold_frac",
               "drift_z_threshold", "recovered_within_eps", "eps",
               "finetune_rounds_per_swap", "swap_count", "zero_downtime",
               "tickets", "swap_kinds")


def test_drift_cell_discrete_fields_match_jax(drift_pair):
    want, got = drift_pair
    for key in DRIFT_EXACT:
        assert got[key] == want[key], key
    assert got["swap_count"] >= 1
    assert got["buffer_occupancy"] == want["buffer_occupancy"]
    for key in ("updates", "drifted_gateways"):
        if key in want["monitor"]:
            assert got["monitor"][key] == want["monitor"][key], key


def test_drift_cell_aucs_match_jax(drift_pair):
    want, got = drift_pair
    for key in ("auc_pre_shift", "auc_final_adapted", "auc_final_frozen"):
        assert_auc_close(got[key], want[key], key)
    assert len(got["stage_rows"]) == len(want["stage_rows"])
    for g, w in zip(got["stage_rows"], want["stage_rows"]):
        for key in ("stage", "hold", "shift_sigma", "swaps_so_far",
                    "new_swaps_this_stage", "buffer_fill"):
            assert g[key] == w[key], (g["stage"], key)
        for key in ("auc_live", "auc_frozen"):
            assert_auc_close(g[key], w[key], (g["stage"], key))


DRIFT_ACCEPTANCE = {
    "all_met": {},
    "not_recovered": {"recovered_within_eps": False},
    "dropped_ticket": {"zero_downtime": False},
    "frozen_held": {"auc_final_frozen": 0.8},
}


@pytest.mark.parametrize("case", list(DRIFT_ACCEPTANCE))
def test_drift_acceptance_matches_jax(case, monkeypatch, tmp_path):
    """The JAX driver's main() over stub cells: the port's acceptance_block
    on the same cells gives its acceptance."""
    def cell(delta, kind, stages, **kw):
        row = {"delta_sigma": delta, "score_kind": kind,
               "auc_pre_shift": 0.85, "auc_final_adapted": 0.95,
               "auc_final_frozen": 0.3, "swap_count": 2,
               "recovered_within_eps": True, "zero_downtime": True,
               "finetune_rounds_per_swap": 5}
        if case == "frozen_held" or (delta == 1.5 and kind == "mse"):
            row.update(DRIFT_ACCEPTANCE[case])
        return row

    out = tmp_path / "fw.json"
    monkeypatch.setattr(drift_recovery_sweep, "run_cell", cell)
    monkeypatch.setattr(sys, "argv", ["drift_recovery_sweep.py", "--out",
                                      str(out)])
    drift_recovery_sweep.main()
    want = json.loads(out.read_text())["acceptance"]
    rows = [cell(d, k, s) for d, k, s, _ in
            drift_recovery_sweep_torch.grid(False)]
    got = drift_recovery_sweep_torch.acceptance_block(rows)
    assert got == want
    assert all(got.values()) == (case == "all_met")


def test_drift_quick_driver_on_the_cpu(tmp_path, monkeypatch):
    """`--quick --device cpu` writes the one cell and its acceptance."""
    monkeypatch.setattr(drift_recovery_sweep_torch, "ROWS_PER_STAGE", 96)
    out = tmp_path / "fw.json"
    drift_recovery_sweep_torch.main(["--quick", "--device", "cpu", "--out",
                                     str(out)])
    art = json.loads(out.read_text())
    assert len(art["cells"]) == 1
    cell = art["cells"][0]
    assert cell["tickets"]["rows_submitted"] == 96 * 6 * (1 + 3 + 2)
    assert cell["zero_downtime"] is True
    assert art["acceptance"]["max_finetune_rounds_per_swap"] == 5


# ----------------------------------------------------------- paper check ----

def write_tree(root, n_clients, dim, n_normal=240, n_abnormal=96, seed=0):
    """A Client-k shard tree of headerless CSVs (normal, abnormal,
    test_normal), the layout DatasetConfig.for_client_dirs reads."""
    rng = np.random.default_rng(seed)
    for k in range(1, n_clients + 1):
        for split, n, shift in (("normal", n_normal, 0.0),
                                ("abnormal", n_abnormal, 3.0),
                                ("test_normal", 30, 0.0)):
            d = os.path.join(root, f"Client-{k}", split)
            os.makedirs(d, exist_ok=True)
            np.savetxt(os.path.join(d, "data.csv"),
                       rng.normal(shift, 1.0, size=(n, dim)), delimiter=",")
    return str(root)


@pytest.fixture(scope="module")
def paper_pair(tmp_path_factory):
    """measure(--quick, 2 runs) of both drivers on one 4-client tree at
    width 16, each run's JAX init carried into the port."""
    tree = write_tree(tmp_path_factory.mktemp("paper"), 4, WIDTH)
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        no_tie_configs(mp, dim_features=WIDTH)
        recorded_inits(mp, jax_federation, inits)
        want = paper_check.measure(tree, runs=2, quick=True)
    layout = ParamLayout(WIDTH, 27, 7)
    got = paper_check_torch.measure(
        tree, runs=2, quick=True, device="cpu",
        states=[carried(s, layout) for s in inits[1:]],
        base=ExperimentConfig(dim_features=WIDTH,
                              compat=CompatConfig(**NO_TIE)))
    return want, got


@pytest.mark.parametrize("run", [0, 1])
def test_paper_check_run_matches_jax(paper_pair, run):
    want, got = paper_pair
    w, g = want["runs"][run], got["runs"][run]
    assert g["rounds_run"] == w["rounds_run"] == 3
    for key in ("best_round_mean", "final_mean", "round_means"):
        assert_auc_close(g[key], w[key], key)


def test_paper_check_summary_matches_jax(paper_pair):
    want, got = paper_pair
    for key in ("n_clients", "data_seed"):
        assert got[key] == want[key], key
    for key in ("best_round_mean_avg", "final_mean_avg"):
        assert_auc_close(got[key], want[key], key)
    assert got["protocol"].endswith(
        "5 epochs, 3 rounds, lr 1e-3, lambda 5, no global early stop")


def test_paper_check_cli_on_the_cpu(tmp_path):
    tree = write_tree(tmp_path / "tree", 2, WIDTH, n_normal=120,
                      n_abnormal=48, seed=1)
    base = ExperimentConfig(dim_features=WIDTH)
    out = paper_check_torch.measure(tree, runs=1, quick=True,
                                    data_seed=7, device="cpu", base=base)
    assert out["data_seed"] == 7 and out["n_clients"] == 2
    assert out["runs"][0]["rounds_run"] == 3
    with pytest.raises(FileNotFoundError, match="Client-"):
        paper_check_torch.measure(str(tmp_path), device="cpu", base=base)


# -------------------------------------------------------- quirk ablation ----

QUIRK_RUNS = 2
QUIRK_KW = dict(dim_features=WIDTH, network_size=4, epochs=1)


@pytest.fixture(scope="module")
def quirk_setup():
    jcfg = JaxConfig(**QUIRK_KW, compat=JaxCompat(**NO_TIE))
    tcfg = ExperimentConfig(**QUIRK_KW, compat=CompatConfig(**NO_TIE))
    jclients = jax_synthetic(n_clients=4, dim=WIDTH, n_normal=240,
                             n_abnormal=120, seed=0)
    tclients = synthetic_clients(n_clients=4, dim=WIDTH, n_normal=240,
                                 n_abnormal=120, seed=0)
    dev_x = jax_dev(jclients, np.random.default_rng(1234))
    jdata = jax_stack(jclients, dev_x, jcfg.batch_size)
    tdata = stack_clients(tclients, dev_x, jcfg.batch_size, device="cpu")
    model = jax_make_model("hybrid", WIDTH, shrink_lambda=jcfg.shrink_lambda)
    inits = [carried(numpy_tree(JaxEngine(
        model, jcfg, jdata, n_real=4,
        rngs=JaxRngs(run=r, data_seed=jcfg.data_seed,
                     run_seed_stride=jcfg.run_seed_stride),
        model_type="hybrid", update_type="mse_avg").states),
        ParamLayout(WIDTH, 27, 7)) for r in range(QUIRK_RUNS)]
    return jcfg, tcfg, jdata, tdata, inits


@pytest.mark.parametrize("field", [None, *quirk_ablation_torch.FIELDS[:5]],
                         ids=lambda f: f or "baseline")
def test_quirk_variant_matches_jax(quirk_setup, field, monkeypatch):
    """One variant, QUIRK_RUNS runs sharing one early stop unless the
    variant resets it: the same rounds run and final AUCs within 2e-3."""
    jcfg, tcfg, jdata, tdata, inits = quirk_setup
    monkeypatch.setattr(quirk_ablation, "NUM_RUNS", QUIRK_RUNS)
    monkeypatch.setattr(quirk_ablation_torch, "NUM_RUNS", QUIRK_RUNS)
    jv = dict(quirk_ablation_torch.variants(jcfg, () if field is None
                                            else (field,)))
    tv = dict(quirk_ablation_torch.variants(tcfg, () if field is None
                                            else (field,)))
    name = list(tv)[-1]
    want = quirk_ablation.run_variant(name, jv[name], jdata, 4)
    got = quirk_ablation_torch.run_variant(name, tv[name], tdata, 4,
                                           states=inits)
    assert got["variant"] == want["variant"]
    assert got["rounds_run"] == want["rounds_run"]
    for key in ("final_auc_mean", "final_auc_std", "auc_runs"):
        assert_auc_close(got[key], want[key], key)


def test_quirk_10b_shares_one_early_stop(monkeypatch):
    """The baseline hands every run the same GlobalEarlyStop, carried over;
    global_early_stop_state_shared=False resets it before each run."""
    seen = []

    def fake(cfg, data, n_real, mt, ut, run, early_stop=None, states=None):
        seen.append((id(early_stop), early_stop.best, early_stop.worse))
        early_stop.best, early_stop.worse = 0.5 - run, 1
        return {"final_metrics": np.array([0.9]), "rounds_run": 3 - run}

    import fedmse_tpu_torch.main as port_main
    monkeypatch.setattr(port_main, "run_combination", fake)
    monkeypatch.setattr(quirk_ablation_torch, "NUM_RUNS", 3)
    cfg = ExperimentConfig()
    row = quirk_ablation_torch.run_variant("baseline", cfg, None, 1)
    assert len({s[0] for s in seen}) == 1
    assert seen[1][1:] == (0.5, 1) and seen[2][1:] == (-0.5, 1)
    assert row["rounds_run"] == [3, 2, 1]
    seen.clear()
    fixed = dict(quirk_ablation_torch.variants(
        cfg, ("global_early_stop_state_shared",)))
    quirk_ablation_torch.run_variant(
        "fixed", fixed["fixed: global_early_stop_state_shared=False"], None,
        1)
    assert all(s[1:] == (np.inf, 0) for s in seen)


def test_quirk_vote_tie_break_row_on_the_port(quirk_setup, monkeypatch):
    """The tie-break row (the port's own draws): the tie-break on against
    off, each run finite with at least one round."""
    _, tcfg, _, tdata, inits = quirk_setup
    monkeypatch.setattr(quirk_ablation_torch, "NUM_RUNS", QUIRK_RUNS)
    cfg = tcfg.replace(compat=CompatConfig())
    rows = quirk_ablation_torch.ablate(cfg, tdata, 4, ("vote_tie_break",),
                                       states=inits)
    assert [r["variant"] for r in rows] == [
        "baseline (all reference quirks)", "fixed: vote_tie_break=False"]
    for row in rows:
        assert np.isfinite(row["auc_runs"]).all()
        assert min(row["rounds_run"]) >= 1
    assert rows[1]["delta_vs_baseline"] == round(
        rows[1]["final_auc_mean"] - rows[0]["final_auc_mean"], 5)


# --------------------------------------------------------- parity probe ----

@pytest.mark.parametrize("case", ["plain", "ties", "constant_column",
                                  "diverged"])
def test_centroid_auc_equals_sklearn(case):
    """The numpy centroid AUC equals the JAX probe's sklearn one to 1e-12."""
    rng = np.random.default_rng({"plain": 0, "ties": 1,
                                 "constant_column": 2, "diverged": 3}[case])
    train = rng.normal(size=(80, 7))
    test = rng.normal(size=(60, 7)) * 2.0
    y = (rng.random(60) < 0.4).astype(np.float32)
    if case == "ties":
        train, test = np.round(train), np.round(test)
    if case == "constant_column":
        train[:, 3] = 1.5
    if case == "diverged":
        test[5, 2], train[7, 1] = np.inf, np.nan
    want = parity_probe._centroid_auc(train, test, y)
    got = parity_probe_torch.centroid_auc(train, test, y)
    assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("a,b", [([0.9, 0.91, 0.95], [0.8, 0.82, 0.79]),
                                 ([0.9, 0.9], [0.9, 0.9]),
                                 ([0.9, 0.9], [0.8, 0.8]), ([0.9], [0.8])])
def test_welch_t_matches_jax(a, b):
    assert parity_probe_torch.welch_t(a, b) == parity_probe.welch_t(a, b)


@pytest.fixture(scope="module")
def parity_tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("parity"), 2, 115,
                      n_normal=300, n_abnormal=100, seed=2)


@pytest.fixture(scope="module")
def parity_pair(parity_tree, tmp_path_factory):
    """The paired trajectory of both drivers on client 1 of the tree, the
    JAX engine's init carried into the port."""
    out = tmp_path_factory.mktemp("parity-out") / "p.json"
    inits = []
    with pytest.MonkeyPatch.context() as mp:
        recorded_inits(mp, jax_federation, inits)
        mp.setattr(sys, "argv", ["parity_probe.py", "--shards", parity_tree,
                                 "--client", "1", "--out", str(out)])
        parity_probe.main()
    want = json.loads(out.read_text())
    got = parity_probe_torch.probe(
        parity_tree, client=1, device="cpu",
        states=carried(inits[0], ParamLayout(115, 27, 7)))
    return want, got


def test_parity_trajectory_matches_jax(parity_pair):
    want, got = parity_pair
    for side in ("ours", "torch_replica"):
        for key in ("train_loss", "valid_loss"):
            assert len(got[side][key]) == len(want[side][key]), (side, key)
            np.testing.assert_allclose(got[side][key], want[side][key],
                                       atol=LOSS_TOL, err_msg=side + key)
        assert_auc_close(got[side]["auc"], want[side]["auc"], side)
    assert got["same_stop_epoch"] == want["same_stop_epoch"]
    assert got["verdict"] == want["verdict"]


def test_parity_probe_fields(parity_pair):
    want, got = parity_pair
    for key in ("client", "data_seed", "epochs_protocol"):
        assert got[key] == want[key], key
    assert_auc_close(got["auc_delta"], want["auc_delta"], "auc_delta")
    assert "solo" not in got


def test_parity_solo_replica_side_matches_jax(parity_tree, tmp_path):
    """--solo 2: the replica side (torch's own init draws) equal to the
    JAX probe's; the port's side on its own streams, finite."""
    out = tmp_path / "solo.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["parity_probe.py", "--shards", parity_tree,
                                 "--client", "1", "--solo", "2", "--epochs",
                                 "2", "--out", str(out)])
        parity_probe.main()
    want = json.loads(out.read_text())
    got = parity_probe_torch.probe(parity_tree, client=1, epochs=2, solo=2,
                                   device="cpu")["solo"]
    assert got["torch_replica"] == want["torch_replica"]
    assert got["n_per_side"] == want["n_per_side"] == 2
    assert got["ours"]["diverged"] == 0
    assert all(1 <= s <= 2 for s in got["ours"]["stop_epochs"])
    assert np.isfinite(got["ours"]["aucs"]).all()
