"""The port's batched runs (fedmse_tpu_torch/federation/batched.py, the
batched round of federation/fused.py, pipeline.run_pipelined_batched and
main.run_batched_combination / --batch-runs), at width 16 / 8 / 3 on 4
clients:

  * the streams: run r's selections, init and tie-break draws, and its
    chaos and elastic masks, are what the sequential driver's run r draws;
  * a batched chunk of R = 3 runs equals 3 sequential port runs on the CPU
    bit for bit (selections, elections, metrics, states), with the
    tie-break on and off and under the fault hooks, and a frozen lane
    keeps its run's state and quota bit for bit;
  * the driver: per-run early stops, mid-chunk (a rewind and replay) and
    at a chunk's last round, pipelined and serial, write the sequential
    driver's artifacts; it refuses what the JAX driver refuses;
  * against the JAX BatchedRunEngine from one init over 2 rounds (plain,
    attacked, chaos and elastic, with the JAX masks fed to the port):
    params within 1e-5 scale-normalized, aggregators identical.
"""

import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.chaos import ChaosSpec as JaxChaosSpec
from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.federation import AttackSpec as JaxAttackSpec
from fedmse_tpu.federation import BatchedRunEngine as JaxBatched
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec
from fedmse_tpu.federation import make_poison_fn as jax_make_poison_fn
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu_torch.chaos import (ChaosMasks, ChaosSpec,
                                    make_batched_chaos_masks,
                                    make_chaos_masks)
from fedmse_tpu_torch.checkpointing import ResultsWriter
from fedmse_tpu_torch.config import DatasetConfig
from fedmse_tpu_torch.federation import client_states_from_numpy
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.batched import (BatchedRunEngine,
                                                 tile_federated_data)
from fedmse_tpu_torch.federation.elastic import (
    ElasticSpec, MembershipMasks, make_batched_membership_masks,
    make_membership_masks)
from fedmse_tpu_torch.federation.state import (concat_states,
                                               init_batched_client_states,
                                               init_client_states)
from fedmse_tpu_torch.main import (GlobalEarlyStop, main,
                                   run_batched_combination, run_combination)
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import ExperimentRngs, make_run_rngs
from tests.torch_fault_common import (BASE, DATA, DIMS, LAYOUT, N,
                                      assert_same_round, assert_same_states,
                                      flat, leaf_err, port_cfg, port_data,
                                      port_engine)

torch.set_num_threads(1)

RUNS = 3


def batched(cfg, data, runs=RUNS, model_type="hybrid",
            update_type="mse_avg", **kw):
    return BatchedRunEngine(
        make_model(model_type, *DIMS, cfg.shrink_lambda, device="cpu"), cfg,
        data, n_real=N, runs=runs, model_type=model_type,
        update_type=update_type, **kw)


def run_rows(engine, k, active=None):
    """k rounds of every run in one chunk, absorbed: [run][round]
    RoundResults."""
    active = np.ones(engine.runs, bool) if active is None else active
    outs, sched, _ = engine.run_schedule_chunk(0, k, active)
    return [[engine.process_round(r, i, sched[i][r], outs, i)
             for i in range(k)] for r in range(engine.runs)]


def run_states(engine, r):
    """Run r's ClientStates rows of a batched engine."""
    return engine.states.apply(lambda t: t.chunk(engine.runs)[r])


# ---------------------------------------------------------- the streams ----

def test_run_rngs_are_the_sequential_streams():
    rngs = make_run_rngs(RUNS, data_seed=7, run_seed_stride=11)
    for r, got in enumerate(rngs):
        want = ExperimentRngs(run=r, data_seed=7, run_seed_stride=11)
        assert got.run_seed == want.run_seed
        assert got.select_rng.random() == want.select_rng.random()
        assert torch.equal(torch.rand(5, generator=got.generator),
                           torch.rand(5, generator=want.generator))
        assert got.chaos_key() == want.chaos_key()


def test_batched_init_and_masks_are_each_runs():
    model = make_model("hybrid", *DIMS, device="cpu")
    rngs = make_run_rngs(RUNS)
    states = init_batched_client_states(model, [r.generator for r in rngs],
                                        N, device="cpu")
    for r in range(RUNS):
        want = init_client_states(
            model, N, ExperimentRngs(run=r).generator, device="cpu")
        assert_same_states(states.apply(lambda t: t.chunk(RUNS)[r]), want)
    cspec = ChaosSpec(dropout_p=0.3, crash_p=0.4, broadcast_loss_p=0.2)
    espec = ElasticSpec(leave_p=0.2, join_p=0.5)
    chaos = make_batched_chaos_masks(cspec, [r.chaos_key() for r in rngs],
                                     1, 4, N)
    member = make_batched_membership_masks(
        espec, [r.elastic_key() for r in rngs], 5, N)
    for r in range(RUNS):
        one = make_chaos_masks(cspec, rngs[r].chaos_key(), 1, 4, N)
        for got, want in zip(chaos, one):
            np.testing.assert_array_equal(got[:, r], want)
        one = make_membership_masks(espec, rngs[r].elastic_key(), 5, N)
        for got, want in zip(member, one):
            np.testing.assert_array_equal(got[:, r], want)
    tiled = tile_federated_data(port_data(port_cfg()), RUNS)
    assert tiled.train_xb.shape[0] == RUNS * N


# ------------------------------------------ batched = sequential, CPU ----

def _sequential(cfg, data, k, model_type="hybrid", update_type="mse_avg",
                **hooks):
    out = []
    for r in range(RUNS):
        eng = port_engine(cfg, model_type, update_type, data=data, run=r,
                          **hooks)
        out.append((eng.run_rounds(0, k), eng))
    return out


def _assert_runs_equal(bat, rows, seq):
    for r, (want_rows, want) in enumerate(seq):
        for got, ref in zip(rows[r], want_rows):
            assert_same_round(got, ref)
        assert_same_states(run_states(bat, r), want.states)
        np.testing.assert_array_equal(bat.host[r].aggregation_count,
                                      want.host.aggregation_count)


@pytest.mark.parametrize("model_type,update_type,tie_break", [
    ("hybrid", "mse_avg", False), ("hybrid", "mse_avg", True),
    ("autoencoder", "fedprox", True), ("hybrid", "avg", False)])
def test_batched_chunk_is_the_sequential_runs(model_type, update_type,
                                              tie_break):
    cfg = port_cfg(tie_break=tie_break)
    data = port_data(cfg)
    seq = _sequential(cfg, data, 3, model_type, update_type)
    bat = batched(cfg, data, model_type=model_type, update_type=update_type)
    _assert_runs_equal(bat, run_rows(bat, 3), seq)
    assert any(r.aggregator is not None for rows, _ in seq for r in rows)


@pytest.mark.parametrize("hooks", [
    dict(poison_fn=AttackSpec(kind="noise", strength=0.5, start_round=1),
         chaos=ChaosSpec(dropout_p=0.2, crash_p=0.5, broadcast_loss_p=0.2)),
    dict(elastic=ElasticSpec(leave_p=0.3, join_p=0.5),
         chaos=ChaosSpec(straggler_p=0.3))])
def test_batched_fault_hooks_are_the_sequential_runs(hooks):
    cfg = port_cfg(tie_break=True)
    data = port_data(cfg)

    def made():
        out = dict(hooks)
        if "poison_fn" in out:
            out["poison_fn"] = make_poison_fn(out["poison_fn"])
        return out
    seq = _sequential(cfg, data, 3, **made())
    bat = batched(cfg, data, **made())
    _assert_runs_equal(bat, run_rows(bat, 3), seq)
    if "elastic" in hooks:
        for r, (_, eng) in enumerate(seq):
            np.testing.assert_array_equal(bat.members_at(3, r),
                                          eng.members_at(3))


def test_a_frozen_run_keeps_its_state_and_quota():
    """Run 1 frozen after round 1 of 3: its lane keeps launching, but its
    states and quota are the sequential run's after one round, bit for
    bit; the live runs are unaffected."""
    cfg = port_cfg()
    data = port_data(cfg)
    seq = _sequential(cfg, data, 3)
    one = port_engine(cfg, data=data, run=1)
    one.run_rounds(0, 1)
    bat = batched(cfg, data)
    active = np.ones((3, RUNS), bool)
    active[1:, 1] = False
    outs, sched, _ = bat.run_schedule_chunk(0, 3, np.ones(RUNS, bool),
                                            active_rounds=active)
    assert_same_states(run_states(bat, 1), one.states)
    np.testing.assert_array_equal(bat.fused_round().agg_count[1].numpy(),
                                  one.host.aggregation_count)
    for r in (0, 2):
        assert_same_states(run_states(bat, r), seq[r][1].states)


# ----------------------------------------------------------- the driver ----

def _walk(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, files in os.walk(root) for f in files}


def _driver_pair(tmp_path, cfg, data):
    """The sequential driver's R runs and run_batched_combination, each with
    its own writer; returns (sequential outs, batched outs, roots)."""
    names = [f"dev-{i}" for i in range(N)]
    roots = [str(tmp_path / "seq"), str(tmp_path / "bat")]
    writers = [ResultsWriter(root, cfg.network_size, cfg.experiment_name,
                             cfg.scen_name, cfg.metric, cfg.num_participants)
               for root in roots]
    seq = [run_combination(
        cfg, data, N, "hybrid", "mse_avg", r, writer=writers[0],
        early_stop=GlobalEarlyStop(inverted=True,
                                   patience=cfg.global_patience),
        device_names=names, save_checkpoints=True) for r in range(RUNS)]
    bat = run_batched_combination(cfg, data, N, "hybrid", "mse_avg",
                                  writer=writers[1], device_names=names,
                                  save_checkpoints=True)
    return seq, bat, roots


@pytest.mark.parametrize("chunk,patience,pipelined", [
    # run 1 stops at round 3 (4, 1) or 4 (2, 2) or 5 (2, 3), runs 0 and 2
    # run all 6 rounds
    (4, 1, True),   # a mid-chunk stop: a rewind, then a re-dispatch
    (3, 1, True),   # a stop at a chunk's last round, then a re-dispatch
    (2, 3, True),   # a mid-chunk stop in the last chunk
    (4, 1, False), (2, 2, False)])
def test_batched_driver_writes_the_sequential_artifacts(tmp_path, chunk,
                                                        patience, pipelined):
    cfg = port_cfg(num_rounds=6, fused_schedule_chunk=chunk,
                   global_patience=patience, num_runs=RUNS,
                   fused_pipeline=pipelined)
    data = port_data(cfg)
    seq, bat, roots = _driver_pair(tmp_path, cfg, data)
    stops = [o["rounds_run"] for o in seq]
    assert min(stops) < cfg.num_rounds  # some run stopped early
    for s, b in zip(seq, bat):
        assert b["rounds_run"] == s["rounds_run"]
        assert b["aggregation_count"] == s["aggregation_count"]
        np.testing.assert_array_equal(b["final_metrics"], s["final_metrics"])
        for x, y in zip(b["rounds"], s["rounds"]):
            assert_same_round(x, y)
    seq_files, bat_files = _walk(roots[0]), _walk(roots[1])
    assert set(seq_files) == set(bat_files)
    for rel, path in seq_files.items():
        if rel.endswith(".json"):
            with open(path, "rb") as a, open(bat_files[rel], "rb") as b:
                assert a.read() == b.read(), rel
        elif rel.endswith(".npz"):
            a, b = np.load(path), np.load(bat_files[rel])
            assert set(a.files) == set(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
        elif rel.endswith(".pkl"):
            with open(path, "rb") as a, open(bat_files[rel], "rb") as b:
                ra, rb = pickle.load(a), pickle.load(b)
            assert len(ra) == len(rb)
            for x, y in zip(ra, rb):
                np.testing.assert_equal(x, y)


def test_single_run_and_the_time_metric():
    cfg = port_cfg()
    data = port_data(cfg)
    one = batched(cfg, data, runs=1)
    rows = run_rows(one, 2)
    assert rows[0][1].aggregator in rows[0][1].selected
    with pytest.raises(ValueError, match="time"):
        batched(port_cfg(metric="time"), data)


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("batched_shards")
    for k in range(1, N + 1):
        for split, n, s in (("normal", 80, 0.0), ("abnormal", 30, 4.0),
                            ("test_normal", 15, 0.0)):
            d = root / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(s, 1.0, (n, 12)),
                       delimiter=",")
    path = root / "config.json"
    path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(root), N).to_json()))
    return str(path)


def _cli(dataset_json, tmp_path, *flags):
    return main(["--dataset-config", dataset_json, "--device", "cpu",
                 "--model-types", "hybrid", "--update-types", "mse_avg",
                 "--network-size", str(N), "--dim-features", "12",
                 "--epochs", "1", "--batch-size", "8", "--num-rounds", "2",
                 "--num-runs", "2", "--checkpoint-dir", str(tmp_path),
                 "--batch-runs", *flags])


def test_cli_batch_runs_and_its_refusals(dataset_json, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    out = _cli(dataset_json, tmp_path / "a", "--no-save")
    assert set(out["results"]) == {"hybrid/mse_avg/run0",
                                   "hybrid/mse_avg/run1"}
    assert not any("--batch-runs disabled" in r.getMessage()
                   for r in caplog.records)
    ref = main(["--dataset-config", dataset_json, "--device", "cpu",
                "--model-types", "hybrid", "--update-types", "mse_avg",
                "--network-size", str(N), "--dim-features", "12",
                "--epochs", "1", "--batch-size", "8", "--num-rounds", "2",
                "--num-runs", "2", "--checkpoint-dir", str(tmp_path / "s"),
                "--no-save"])
    for key, want in ref["results"].items():
        np.testing.assert_array_equal(out["results"][key]["final_metrics"],
                                      want["final_metrics"])
    for flags, why in ((("--resume-dir", str(tmp_path / "r")),
                        "--resume-dir"),
                       (("--cluster-k", "2"), "--cluster-k"),
                       (("--fused-schedule", "false"), "fused_schedule")):
        caplog.clear()
        out = _cli(dataset_json, tmp_path / why.strip("-"), "--no-save",
                   *flags)
        msgs = [r.getMessage() for r in caplog.records
                if "--batch-runs disabled" in r.getMessage()]
        assert len(msgs) == 1 and why in msgs[0]
        assert len(out["results"]) == 2


# ------------------------------------------------- against the JAX one ----

def _jax_pair(horizon=2, attack=None, chaos=None, elastic=None):
    """(JAX BatchedRunEngine, port engine) from the JAX engine's R inits,
    with its chaos masks and membership timelines fed to the port."""
    jcfg = JaxConfig(**BASE, num_runs=RUNS,
                     compat=JaxCompat(vote_tie_break=False))
    tcfg = port_cfg(num_runs=RUNS)
    jclients = jax_synthetic(**DATA)
    data = port_data(tcfg)
    dev_x = data.dev_x.numpy()
    jkw, tkw = {}, {}
    if attack is not None:
        jkw["poison_fn"] = jax_make_poison_fn(JaxAttackSpec(**attack))
        tkw["poison_fn"] = make_poison_fn(AttackSpec(**attack))
    if chaos is not None:
        jkw["chaos"], tkw["chaos"] = JaxChaosSpec(**chaos), ChaosSpec(**chaos)
    if elastic is not None:
        jkw["elastic"] = JaxElasticSpec(**elastic)
        tkw["elastic"] = ElasticSpec(**elastic)
    jeng = JaxBatched(jax_make_model("hybrid", *DIMS, jcfg.shrink_lambda),
                      jcfg, jax_stack(jclients, dev_x, 12), n_real=N,
                      runs=RUNS, model_type="hybrid", update_type="mse_avg",
                      **jkw)
    init = concat_states([client_states_from_numpy(
        jax.tree.map(lambda t: np.array(t[r]), jeng.states), LAYOUT,
        device="cpu") for r in range(RUNS)])
    if elastic is not None:
        tkw["elastic_masks"] = MembershipMasks(*(
            np.asarray(m) for m in jeng._elastic_masks(0, horizon)))
    teng = batched(tcfg, data, states=init, **tkw)
    if chaos is not None:
        held = ChaosMasks(*(np.asarray(m)
                            for m in jeng._chaos_masks(0, horizon)))
        teng._chaos_masks = lambda start, k: ChaosMasks(
            *(m[start:start + k] for m in held))
    return jeng, teng


@pytest.mark.parametrize("hooks", [
    {}, dict(attack=dict(kind="scale", strength=50.0, start_round=1)),
    dict(chaos=dict(dropout_p=0.3, crash_p=0.5, broadcast_loss_p=0.2)),
    dict(elastic=dict(leave_p=0.3, join_p=0.6))])
def test_batched_matches_the_jax_batched_engine(hooks):
    jeng, teng = _jax_pair(**hooks)
    active = np.ones(RUNS, bool)
    jouts, jsched, _ = jeng.run_schedule_chunk(0, 2, active)
    touts, tsched, _ = teng.run_schedule_chunk(0, 2, active)
    assert tsched == [[list(s) for s in row] for row in jsched]
    for i in range(2):
        for r in range(RUNS):
            want = jeng.process_round(r, i, jsched[i][r], jouts, i)
            got = teng.process_round(r, i, tsched[i][r], touts, i)
            assert got.aggregator == want.aggregator
            assert got.crashed_aggregator == want.crashed_aggregator
            assert got.members == want.members
            assert got.verification_results == want.verification_results
            np.testing.assert_allclose(got.client_metrics,
                                       want.client_metrics, atol=2e-3)
    for r in range(RUNS):
        want = jax.tree.map(lambda t: t[r], jeng.states)
        for name in ("params", "prev_global", "hist_params"):
            assert leaf_err(getattr(run_states(teng, r), name),
                            flat(getattr(want, name))) <= 1e-5, name
