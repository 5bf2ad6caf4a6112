"""The port's threat-model sweep drivers (attack_sweep_torch.py,
chaos_sweep_torch.py, churn_sweep_torch.py, redteam_sweep_torch.py and
their shared sweep_data_torch.py) held against the JAX drivers, whose
`run_cell` and cell functions are called unchanged.

Each pair runs on the same data with the JAX engine's init carried into
the port (`states=`), the JAX engine's chaos masks and membership timeline
fed through `chaos_masks=` / `elastic_masks=`, and the vote tie-break off
on both sides. Discrete fields (accept rates, rejected curves, flags,
participation, elections, membership and generation counts,
rounds_to_recover, each bar's truth value) must be equal; AUC fields agree
within 2e-3; the null-spec pins are bit-equal on the port's own side.
Sizes: width 16, 4 to 20 clients, 3 to 16 rounds of 1 to 2 epochs.
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

import attack_sweep  # noqa: E402
import attack_sweep_torch  # noqa: E402
import chaos_sweep  # noqa: E402
import chaos_sweep_torch  # noqa: E402
import churn_sweep  # noqa: E402
import churn_sweep_torch  # noqa: E402
import redteam_sweep  # noqa: E402
import redteam_sweep_torch  # noqa: E402
import sweep_data_torch  # noqa: E402
from fedmse_tpu.chaos import ChaosSpec as JaxChaosSpec  # noqa: E402
from fedmse_tpu.chaos import joiner_incumbent_gap as jax_gap  # noqa: E402
from fedmse_tpu.config import CompatConfig as JaxCompat  # noqa: E402
from fedmse_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from fedmse_tpu.data import build_dev_dataset as jax_dev  # noqa: E402
from fedmse_tpu.data import stack_clients as jax_stack  # noqa: E402
from fedmse_tpu.data import synthetic_clients as jax_synthetic  # noqa: E402
from fedmse_tpu.federation import AttackSpec as JaxAttackSpec  # noqa: E402
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec  # noqa: E402
from fedmse_tpu.federation import RoundEngine as JaxEngine  # noqa: E402
from fedmse_tpu.models import make_model as jax_make_model  # noqa: E402
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs  # noqa: E402
from fedmse_tpu_torch.chaos import ChaosSpec  # noqa: E402
from fedmse_tpu_torch.config import (CompatConfig,  # noqa: E402
                                     ExperimentConfig)
from fedmse_tpu_torch.data import (stack_clients,  # noqa: E402
                                   synthetic_clients)
from fedmse_tpu_torch.federation import client_states_from_numpy  # noqa: E402
from fedmse_tpu_torch.federation.attack import AttackSpec  # noqa: E402
from fedmse_tpu_torch.federation.elastic import (ElasticSpec,  # noqa: E402
                                                 MembershipMasks)
from fedmse_tpu_torch.models.flat import ParamLayout  # noqa: E402

torch.set_num_threads(1)

AUC_TOL = 2e-3
WIDTH = 16
HYBRID = ParamLayout(WIDTH, 27, 7)  # the sweeps' make_model defaults


def configs(**kw):
    """(JAX config, port config) with the same fields, tie-break off."""
    return (JaxConfig(**kw, compat=JaxCompat(vote_tie_break=False)),
            ExperimentConfig(**kw, compat=CompatConfig(vote_tie_break=False)))


def datas(jcfg, clients_of, seed_rows=1234):
    """(JAX data, port data on the CPU, n) from one client list drawn by
    each package's generator (bit-equal) and one dev set."""
    jclients, tclients = clients_of("jax"), clients_of("torch")
    dev_x = jax_dev(jclients, np.random.default_rng(seed_rows))
    return (jax_stack(jclients, dev_x, jcfg.batch_size),
            stack_clients(tclients, dev_x, jcfg.batch_size, device="cpu"),
            len(tclients))


def plain_clients(n, n_normal=240, n_abnormal=120):
    return lambda side: (jax_synthetic if side == "jax" else
                         synthetic_clients)(n_clients=n, dim=WIDTH,
                                            n_normal=n_normal,
                                            n_abnormal=n_abnormal, seed=0)


def jax_engine(jcfg, jdata, n, model_type="hybrid", hidden=None, **hooks):
    """The engine a JAX driver's run_cell builds (same model, streams and
    hooks), for its init and fault masks."""
    dims = () if hidden is None else hidden
    model = jax_make_model(model_type, jcfg.dim_features, *dims,
                           shrink_lambda=jcfg.shrink_lambda)
    return JaxEngine(model, jcfg, jdata, n_real=n,
                     rngs=JaxRngs(run=0, data_seed=jcfg.data_seed),
                     model_type=model_type, update_type="mse_avg",
                     fused=True, **hooks)


def carried_init(jeng, layout=HYBRID):
    return client_states_from_numpy(jax.tree.map(np.array, jeng.states),
                                    layout, device="cpu")


def port_masks(jmasks):
    return MembershipMasks(*(np.asarray(m) for m in jmasks))


def assert_auc_close(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), atol=AUC_TOL,
                               err_msg=what)


def assert_rows_match(got, want, auc_keys=("final_auc", "auc_curve"),
                      approx_keys=(), skip=("wall_s", "sec_per_round")):
    """Every key of the JAX row in the port's: AUC keys within 2e-3,
    `approx_keys` within 1e-3 relative, the rest equal."""
    for key, w in want.items():
        if key in skip:
            continue
        assert key in got, key
        if key in auc_keys:
            assert_auc_close(got[key], w, key)
        elif key in approx_keys:
            if w is None or (isinstance(w, list) and None in w):
                assert got[key] == w, key
            else:
                np.testing.assert_allclose(got[key], w, rtol=1e-3,
                                           atol=1e-6, err_msg=key)
        else:
            assert got[key] == w, key


# ---------------------------------------------------------------- data ----

def test_build_data_is_the_harness_federation():
    """sweep_data_torch.build_data's synthetic federation is bench.py's
    fallback recipe (synthetic_clients at 1,700 / 3,300 rows, the dev set
    from the run's data stream) at any client count, tensor for tensor."""
    jcfg, tcfg = configs(dim_features=WIDTH, network_size=4)
    got, n, _ = sweep_data_torch.build_data(tcfg, 4, device="cpu")
    jclients = jax_synthetic(n_clients=4, dim=WIDTH, n_normal=1700,
                             n_abnormal=3300)
    want = jax_stack(jclients, jax_dev(jclients, JaxRngs(
        run=0, data_seed=jcfg.data_seed).data_rng), jcfg.batch_size)
    assert n == 4
    for name in ("train_xb", "train_mb", "valid_x", "test_x", "test_y",
                 "dev_x", "client_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_bulk_federations_are_the_harness_draws():
    """light_clients and bulk_host_federation draw bench.py's
    `_light_clients` / `_bulk_host_federation` rows bit for bit."""
    import bench
    jc, jdev = bench._light_clients(12, WIDTH)
    tc, tdev = sweep_data_torch.light_clients(12, WIDTH)
    np.testing.assert_array_equal(tdev, jdev)
    for a, b in zip(tc, jc):
        for name in ("train_x", "valid_x", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
    want = bench._bulk_host_federation(50, 8, 16)
    got = sweep_data_torch.bulk_host_federation(50, 8, 16)
    for name in ("train_xb", "train_mb", "valid_xb", "valid_mb", "valid_x",
                 "valid_m", "test_x", "test_m", "test_y", "dev_x",
                 "client_mask"):
        t = getattr(got, name)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_churn_grid_is_the_jax_grid():
    jcfg, tcfg = configs(dim_features=WIDTH, network_size=20)
    want, n_want = churn_sweep.build_grid(jcfg, 20)
    got, n_got = churn_sweep_torch.build_grid(tcfg, 20, device="cpu")
    assert n_got == n_want
    for name in ("train_xb", "valid_x", "test_x", "test_y", "dev_x"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# -------------------------------------------------------------- attack ----

ATTACK_KW = dict(dim_features=WIDTH, network_size=4, epochs=2)


@pytest.fixture(scope="module")
def attack_setup():
    jcfg, tcfg = configs(**ATTACK_KW)
    jdata, tdata, n = datas(jcfg, plain_clients(4))
    init = carried_init(jax_engine(jcfg, jdata, n))
    return jcfg, tcfg, jdata, tdata, n, init


@pytest.mark.parametrize("hardened", [False, True],
                         ids=["reference", "hardened"])
@pytest.mark.parametrize("kind,strength", [(None, 0.0), ("scale", 10.0),
                                           ("zero", 1.0)],
                         ids=["baseline", "scale10", "zero"])
def test_attack_cell_matches_jax(attack_setup, kind, strength, hardened):
    jcfg, tcfg, jdata, tdata, n, init = attack_setup
    jcfg = jcfg.replace(hardened_verification=hardened)
    tcfg = tcfg.replace(hardened_verification=hardened)
    want = attack_sweep.run_cell(jcfg, jdata, n, kind, strength, rounds=3)
    got = attack_sweep_torch.run_cell(tcfg, tdata, n, kind, strength,
                                      rounds=3, states=init)
    assert_rows_match(got, want)
    assert got["wall_s"] > 0
    if kind is None:
        assert got["accept_rate"] == 1.0


# --------------------------------------------------------------- chaos ----

CHAOS_KW = dict(dim_features=WIDTH, network_size=6, epochs=1)
BURST = (1, 3)

CHAOS_CELLS = {
    "baseline": (None, None, 3, None),
    "grid": (dict(dropout_p=0.3, crash_p=0.1), None, 3, None),
    "attack+churn": (dict(dropout_p=0.3, crash_p=0.1),
                     dict(kind="scale", strength=50.0, start_round=1), 3,
                     None),
    "churn-burst": (dict(dropout_p=0.8, crash_p=0.5, start_round=BURST[0],
                         stop_round=BURST[1]), None, 6, BURST),
}


@pytest.fixture(scope="module")
def chaos_setup():
    jcfg, tcfg = configs(**CHAOS_KW)
    jdata, tdata, n = datas(jcfg, plain_clients(6))
    init = carried_init(jax_engine(jcfg, jdata, n))
    return jcfg, tcfg, jdata, tdata, n, init


@pytest.mark.parametrize("label", list(CHAOS_CELLS))
def test_chaos_cell_matches_jax(chaos_setup, label):
    jcfg, tcfg, jdata, tdata, n, init = chaos_setup
    chaos, attack, rounds, burst = CHAOS_CELLS[label]
    jchaos = None if chaos is None else JaxChaosSpec(**chaos)
    jattack = None if attack is None else JaxAttackSpec(**attack)
    want = chaos_sweep.run_cell(jcfg, jdata, n, jchaos, jattack,
                                rounds=rounds, burst=burst, label=label)
    masks = None
    if chaos is not None:
        masks = jax_engine(jcfg, jdata, n, chaos=jchaos)._chaos_masks(
            0, rounds)
    got = chaos_sweep_torch.run_cell(
        tcfg, tdata, n, None if chaos is None else ChaosSpec(**chaos),
        None if attack is None else AttackSpec(**attack), rounds=rounds,
        burst=burst, label=label, states=init, chaos_masks=masks)
    assert_rows_match(got, want, approx_keys=(
        "divergence_mean_curve", "final_divergence_mean", "max_divergence"))
    if burst is not None:
        assert got["burst"]["rounds_to_recover"] is not None


def test_chaos_baseline_equals_the_clean_engine(chaos_setup):
    """The (0, 0) cell is the clean fused engine's rounds, bit for bit."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    _, tcfg, _, tdata, n, init = chaos_setup
    row = chaos_sweep_torch.run_cell(tcfg, tdata, n, None, states=init,
                                     rounds=3)
    eng = RoundEngine(make_model("hybrid", WIDTH,
                                 shrink_lambda=tcfg.shrink_lambda,
                                 device="cpu"), tcfg, tdata, n,
                      ExperimentRngs(run=0), "hybrid", "mse_avg",
                      states=init, fused=True)
    results = eng.run_rounds(0, 3)
    assert row["auc_curve"] == [round(float(np.nanmean(r.client_metrics)), 5)
                                for r in results]
    assert np.array_equal(row["final_client_metrics"],
                          results[-1].client_metrics, equal_nan=True)


# --------------------------------------------------------------- churn ----

CHURN_ROUNDS = 8


@pytest.fixture(scope="module")
def churn_setup():
    kw = dict(dim_features=WIDTH, network_size=20, num_participants=0.2,
              num_rounds=CHURN_ROUNDS, epochs=1)
    jcfg, tcfg = configs(**kw)
    jdata, n = churn_sweep.build_grid(jcfg, 20)
    tdata, _ = churn_sweep_torch.build_grid(tcfg, 20, device="cpu")
    init = carried_init(jax_engine(jcfg, jdata, n))
    return jcfg, tcfg, jdata, tdata, n, init


def churn_pair(setup, elastic=None, chaos=None, attack=None, burst=None):
    """(JAX (row, final, generations), port's) for one churn cell."""
    jcfg, tcfg, jdata, tdata, n, init = setup
    jel = None if elastic is None else JaxElasticSpec(**elastic)
    jch = None if chaos is None else JaxChaosSpec(**chaos)
    jat = None if attack is None else JaxAttackSpec(**attack)
    want = churn_sweep.run_cell(jcfg, jdata, n, jel, chaos=jch, attack=jat,
                                rounds=CHURN_ROUNDS, burst=burst)
    ref = jax_engine(jcfg, jdata, n, chaos=jch, elastic=jel)
    got = churn_sweep_torch.run_cell(
        tcfg, tdata, n, None if elastic is None else ElasticSpec(**elastic),
        chaos=None if chaos is None else ChaosSpec(**chaos),
        attack=None if attack is None else AttackSpec(**attack),
        rounds=CHURN_ROUNDS, burst=burst, states=init,
        chaos_masks=(None if chaos is None
                     else ref._chaos_masks(0, CHURN_ROUNDS)),
        elastic_masks=(None if elastic is None
                       else port_masks(ref._elastic_masks(0, CHURN_ROUNDS))))
    return want, got


def assert_churn_match(want, got):
    assert_rows_match(got[0], want[0], approx_keys=(
        "divergence_mean_curve", "final_divergence_mean", "max_divergence"))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=AUC_TOL)
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_churn_null_elastic_matches_jax_and_is_static_bitwise(churn_setup):
    want, got = churn_pair(churn_setup, elastic={})
    assert_churn_match(want, got)
    _, tcfg, _, tdata, n, init = churn_setup
    static = churn_sweep_torch.run_cell(tcfg, tdata, n, None,
                                        rounds=CHURN_ROUNDS, states=init)
    assert np.array_equal(static[1], got[1], equal_nan=True)
    assert static[0]["auc_curve"] == got[0]["auc_curve"]


def test_churn_steady_matches_jax(churn_setup):
    want, got = churn_pair(churn_setup, elastic=dict(
        leave_p=0.3, join_p=0.5, start_round=1))
    assert_churn_match(want, got)
    assert got[0]["membership"]["recycled_slots"] > 0


def test_churn_burst_bars_match_jax(churn_setup):
    """The leave burst and rejoin wave: the JAX row and gap against the
    port's burst_row, both joiner bars' truth values equal."""
    _, _, _, _, n, init = churn_setup
    jcfg, tcfg, jdata, tdata = churn_setup[:4]
    b0, b1 = churn_sweep.BURST
    spec = dict(leave_p=0.3, join_p=0.6, leave_window=(b0, b1),
                join_window=(b1, None))
    base_want = churn_sweep.run_cell(jcfg, jdata, n, None,
                                     rounds=CHURN_ROUNDS)
    want, got = churn_pair(churn_setup, elastic=spec, burst=(b0, b1))
    assert_churn_match(want, got)
    jgap = jax_gap(want[1], want[2], baseline_metrics=base_want[1])
    # the JAX driver's bars, as its main() states them
    jcohort = bool(
        jgap.get("mean_gap") is not None and abs(jgap["mean_gap"]) <= 2e-3
        and jgap.get("per_slot_gap_mean_vs_baseline") is not None
        and jgap["per_slot_gap_mean_vs_baseline"] <= 2e-3)
    jslot = bool(jgap.get("per_slot_gap_vs_baseline") is not None
                 and jgap["per_slot_gap_vs_baseline"]
                 <= churn_sweep.PER_SLOT_MAX_GAP_CEILING)

    ref = jax_engine(jcfg, jdata, n, elastic=JaxElasticSpec(**spec))
    base_got = churn_sweep_torch.run_cell(tcfg, tdata, n, None,
                                          rounds=CHURN_ROUNDS, states=init)
    row = churn_sweep_torch.burst_row(
        tcfg, tdata, n, base_got[1], rounds=CHURN_ROUNDS, states=init,
        elastic_masks=port_masks(ref._elastic_masks(0, CHURN_ROUNDS)))
    for key in ("joiners", "incumbents"):
        assert row["joiner_gap"][key] == jgap[key], key
    for key in ("joiner_mean_auc", "incumbent_mean_auc", "mean_gap",
                "per_slot_gap_vs_baseline", "per_slot_gap_mean_vs_baseline"):
        assert_auc_close(row["joiner_gap"][key], jgap[key], key)
    assert row["joiners_within_2e3_of_incumbents"] == jcohort
    assert row["per_slot_max_gap_within_ceiling"] == jslot
    assert row["burst"] == got[0]["burst"]


def test_capture_once_pin_small_fleet():
    """The pin row at 64 clients on the CPU: the churning chunks reuse the
    warm-up's round (no rebuild), and null churn is static bit for bit;
    on the CPU nothing is captured, so captured_once is not claimed."""
    pin = churn_sweep_torch.capture_once_pin(
        ExperimentConfig(dim_features=WIDTH), torch.device("cpu"), 64, 12)
    assert pin["cohort"] == 12
    assert pin["fused_round_rebuilt"] is False
    assert pin["null_churn_bitwise_identical"] is True
    assert pin["captured_once"] is None
    assert 0 < pin["members_last_round"] <= 64


def test_podscale_rows_on_a_small_tier(tmp_path):
    """--podscale on a 100-gateway tier (CPU): the null-elastic pin, the
    burst row's bars and the acceptance block are written."""
    out = tmp_path / "pod.json"
    churn_sweep_torch.main(["--podscale", "--device", "cpu", "--clients",
                            "100", "--out", str(out)])
    art = json.loads(out.read_text())
    rows = {r["label"]: r for r in art["rows"]}
    assert rows["null-elastic-100k"]["bit_identical_to_static"] is True
    burst = rows["leave-burst-50pct-100k"]
    assert burst["membership"]["recycled_slots"] > 0
    acc = art["acceptance"]
    assert acc["null_bitwise"] is True
    assert acc["met"] == bool(acc["joiner_bars_met"]
                              and acc["per_slot_ceiling_met"])
    assert art["device"] == "cpu" and art["torch"] == torch.__version__


# ------------------------------------------------------------- red team ----

def reduced_base_cfg(orig):
    """A driver's base_cfg at one epoch a round."""
    return lambda **kw: orig(**{"epochs": 1, **kw})


def redteam_init(jcfg, jdata, n, **hooks):
    eng = jax_engine(jcfg, jdata, n, model_type="autoencoder",
                     hidden=(jcfg.hidden_neus, jcfg.latent_dim), **hooks)
    return eng, carried_init(eng, ParamLayout(jcfg.dim_features,
                                              jcfg.hidden_neus,
                                              jcfg.latent_dim))


def test_redteam_defenses_off_pin_matches_jax(monkeypatch):
    monkeypatch.setattr(redteam_sweep, "base_cfg",
                        reduced_base_cfg(redteam_sweep.base_cfg))
    want = redteam_sweep.defenses_off_pin()
    got = redteam_sweep_torch.defenses_off_pin("cpu")
    assert got == want == {"label": "defenses_off_bitwise_pin",
                           "states_bit_identical": True}


def test_redteam_sybil_cells_match_jax(monkeypatch):
    monkeypatch.setattr(redteam_sweep, "base_cfg",
                        reduced_base_cfg(redteam_sweep.base_cfg))
    jrows, jsum = redteam_sweep.sybil_cells()
    jcfg = redteam_sweep.base_cfg(network_size=12, num_rounds=16)
    jdata, n = redteam_sweep.build_plain_grid(jcfg, 12)
    elastic = dict(leave_p=0.0, join_p=0.9, initial_member_frac=0.5,
                   join_window=(8, None))
    eng, init = redteam_init(jcfg, jdata, n,
                             elastic=JaxElasticSpec(**elastic))
    tcfg = redteam_sweep_torch.base_cfg(network_size=12, num_rounds=16,
                                        epochs=1)
    rows, summary = redteam_sweep_torch.sybil_cells(
        "cpu", states=init,
        elastic_masks=port_masks(eng._elastic_masks(0, 16)), cfg=tcfg)
    auc_keys = ("auc_mean", "clean_auc", "defense_only_auc",
                "clean_auc_delta")
    for got, want in zip(rows, jrows):
        for key, w in want.items():
            if key == "note":
                continue
            if key in ("undefended", "min_tenure_6"):
                for k, v in w.items():
                    if k in auc_keys:
                        assert_auc_close(got[key][k], v, k)
                    else:
                        assert got[key][k] == v, (key, k)
            elif key in auc_keys:
                assert_auc_close(got[key], w, key)
            else:
                assert got[key] == w, key
    for key in ("undefended_capture", "defended_capture", "honest_baseline"):
        assert summary[key] == jsum[key], key


def test_redteam_waiver_abuse_matches_jax():
    """The JAX cell's own init (key 0, 4 hybrid clients) carried in: the
    same accepted probes, the cumulative waived norms within 1e-5."""
    import optax
    from fedmse_tpu.federation.state import init_client_states
    jrow, jsum = redteam_sweep.waiver_abuse_cell()
    states = init_client_states(
        jax_make_model("hybrid", redteam_sweep.DIM), optax.adam(1e-3),
        jax.random.key(0), 4)
    row, summary = redteam_sweep_torch.waiver_abuse_cell(
        "cpu", states=carried_init_tree(states))
    for mode in ("undefended", "defended"):
        assert row[mode]["accepted"] == jrow[mode]["accepted"]
    for key in ("undefended_waived", "defended_waived", "budget"):
        np.testing.assert_allclose(summary[key], jsum[key], rtol=1e-5)
    assert summary["defended_waived"] <= 0.5 * summary["undefended_waived"]


def carried_init_tree(states):
    return client_states_from_numpy(jax.tree.map(np.array, states), HYBRID,
                                    device="cpu")


PIN = {"label": "defenses_off_bitwise_pin", "states_bit_identical": True}
CLUSTER = {"undefended_capture": 1.0, "defended_capture": 0.0,
           "insider_auc_drop": 0.1478, "clean_auc_delta": 0.0}
FLYWHEEL = {"undefended_position": 1.0, "defended_position": 0.75,
            "undefended_inflation": 3.5248, "defended_inflation": 1.0335,
            "flooder_share_uncapped": 0.7692, "flooder_share_capped": 0.5946,
            "clean_auc_delta": 0.0}
SYBIL = {"undefended_capture": 0.5, "defended_capture": 0.1429,
         "honest_baseline": 0.375, "clean_auc_delta": 0.0}
WAIVER = {"undefended_waived": 261.419, "defended_waived": 89.2135,
          "budget": 65.3547}
STORM = {"undefended_honest_shed_frac": 0.9667,
         "defended_honest_shed_frac": 0.0, "clean_cost_shed_frac": 0.0,
         "clean_rows_isolated": 0}
GAMING = {"undefended_shed_rows": 2.4e6, "defended_shed_rows": 9.6e5,
          "undefended_scale_flaps": 120, "defended_scale_flaps": 48,
          "clean_extra_usd": 0.000778, "clean_overload_ticks_defended": 0}

ACCEPTANCE_CASES = {
    "all_met": {},
    "pin_broken": {"pin": {"states_bit_identical": False}},
    "cluster_window_missed": {"cl": {"undefended_capture": 0.0}},
    "cluster_clean_cost": {"cl": {"clean_auc_delta": 3e-3}},
    "flywheel_inflation": {"fw": {"defended_inflation": 1.9}},
    "sybil_below_honest": {"sy": {"undefended_capture": 0.125}},
    "waiver_unbounded": {"wv": {"defended_waived": 200.0}},
    "storm_clean_shed": {"st": {"clean_cost_shed_frac": 1e-3}},
    "gaming_flaps": {"cg": {"defended_scale_flaps": 100}},
}


@pytest.mark.parametrize("case", list(ACCEPTANCE_CASES))
def test_redteam_acceptance_matches_jax(case, monkeypatch, tmp_path):
    """The JAX driver's main(), its cells replaced by the same summary
    dicts the port's acceptance_block takes: the same acceptance."""
    edits = ACCEPTANCE_CASES[case]
    cells = {name: {**base, **edits.get(name, {})} for name, base in (
        ("pin", PIN), ("cl", CLUSTER), ("fw", FLYWHEEL), ("sy", SYBIL),
        ("wv", WAIVER), ("st", STORM), ("cg", GAMING))}
    import fedmse_tpu.redteam as jax_redteam
    monkeypatch.setattr(redteam_sweep, "defenses_off_pin",
                        lambda: cells["pin"])
    monkeypatch.setattr(redteam_sweep, "cluster_cells",
                        lambda: ([], cells["cl"]))
    monkeypatch.setattr(redteam_sweep, "flywheel_cells",
                        lambda: ([], cells["fw"]))
    monkeypatch.setattr(redteam_sweep, "sybil_cells",
                        lambda: ([], cells["sy"]))
    monkeypatch.setattr(redteam_sweep, "waiver_abuse_cell",
                        lambda: ({"label": "waiver"}, cells["wv"]))
    monkeypatch.setattr(jax_redteam, "shed_storm_cell",
                        lambda: ([], cells["st"]))
    monkeypatch.setattr(jax_redteam, "cost_gaming_cell",
                        lambda: ([], cells["cg"]))
    out = tmp_path / "rt.json"
    monkeypatch.setattr(sys, "argv", ["redteam_sweep.py", "--out", str(out)])
    redteam_sweep.main()
    want = json.loads(out.read_text())["acceptance"]
    got = redteam_sweep_torch.acceptance_block(*cells.values())
    assert got == want
    assert got["met"] == (case == "all_met")


def test_redteam_cluster_bar_reads_the_defended_window():
    """The cluster bar is read at 0.8 where the fit puts it in the
    defended window, else at the window's first blend; an empty window
    reads 0.8 and fails."""
    caps = {0.7: (0.0, 0.0), 0.8: (0.0, 0.0), 0.85: (1.0, 0.0),
            1.0: (1.0, 1.0)}
    window = redteam_sweep_torch.defended_blends(caps)
    assert window == [0.85]
    assert redteam_sweep_torch.window_blend(window) == 0.85
    assert redteam_sweep_torch.window_blend([0.8, 0.85]) == 0.8
    assert redteam_sweep_torch.window_blend([]) == 0.8


def test_redteam_quick_cell_on_the_cpu():
    out = redteam_sweep_torch.quick_cell("cpu")
    assert out["defenses_off_bitwise"] is True
    assert out["margin_floor_admitted"]["admitted"] == 2
    at = out["mimicry_at_window"]
    assert at["blend"] in out["defended_blends"] or not out["defended_blends"]
    assert out["acceptance_met"] == bool(out["defended_blends"])

