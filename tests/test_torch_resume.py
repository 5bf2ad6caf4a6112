"""The port's whole-federation snapshots (fedmse_tpu_torch/checkpointing/io.py
CheckpointManager, `--resume-dir`) against the JAX package's pod-sharded
snapshot (fedmse_tpu/checkpointing/io.py `save_shard` / `restore_sharded`
at one shard):

  * a snapshot the JAX package wrote restores in the port, and one more
    round from it matches the JAX engine's within 1e-5; the reverse, a
    port snapshot restored by the JAX package;
  * a killed-and-resumed port run equals the uninterrupted run bit for bit
    on the CPU, on the serial chunk loop with a snapshot mid-run, on the
    whole fault path (attack, chaos and elastic composed) and through the
    CLI, which warns that --resume-dir runs the serial loop;
  * a snapshot of another membership timeline, or one written before the
    timeline was recorded, is refused by name; the loss curve survives the
    resume; the serial loop's snapshot hook refuses the pipelined loop.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.checkpointing import CheckpointManager as JaxManager
from fedmse_tpu_torch.chaos import ChaosSpec
from fedmse_tpu_torch.checkpointing import CheckpointManager
from fedmse_tpu_torch.config import DatasetConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import HostState, run_pipelined_schedule
from fedmse_tpu_torch.federation.attack import AttackSpec
from fedmse_tpu_torch.federation.elastic import ElasticSpec
from fedmse_tpu_torch.main import GlobalEarlyStop, run_combination
from tests.torch_fault_common import (LAYOUT, N, assert_same_states, flat,
                                      leaf_err, pair, port_cfg, port_engine)

torch.set_num_threads(1)

TAG = "hybrid_mse_avg_run0"
EXTRA = {"flatten_optimizer": False, "elastic": None, "cluster": None}


def _assert_engine_matches_jax(jeng, teng, want, got):
    assert got.selected == want.selected
    assert got.aggregator == want.aggregator
    assert got.verification_results == want.verification_results
    np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                               atol=2e-3)
    for name in ("params", "prev_global", "hist_params"):
        assert leaf_err(getattr(teng.states, name),
                        flat(getattr(jeng.states, name))) <= 1e-5, name
    np.testing.assert_array_equal(teng.states.rejected.numpy(),
                                  np.asarray(jeng.states.rejected))
    np.testing.assert_array_equal(teng.host.aggregation_count,
                                  jeng.host.aggregation_count)


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """The JAX engine runs 2 rounds and writes its pod-sharded snapshot; a
    fresh port engine restores it (states, counters, round index, curve)
    and both run round 2 on one cohort."""
    jeng, teng = pair()
    for r in range(2):
        jeng.run_round(r)
    curve = np.arange(N * 4 * 3, dtype=np.float32).reshape(N, 4, 3)
    JaxManager(str(tmp_path)).save_shard(
        TAG, jax.tree.map(np.asarray, jeng.states), jeng.host, 2, 0, N,
        [(0, N)], extra=EXTRA, tracking=curve)
    states, host, start, tracking = CheckpointManager(str(tmp_path)).restore(
        TAG, layout=LAYOUT, device="cpu", expected_extra=EXTRA)
    assert start == 2
    np.testing.assert_array_equal(tracking, curve)
    assert host.rounds_aggregated == jeng.host.rounds_aggregated
    np.testing.assert_array_equal(states.rejected.numpy(),
                                  np.asarray(jeng.states.rejected))
    assert leaf_err(states.opt_state.mu, flat(jeng.states.opt_state[0].mu)) \
        == 0
    teng.states, teng.host = states, host
    selected = jeng.select_clients()
    want = jeng.run_round(2, selected=selected)
    got = teng.run_round(2, selected=selected)
    _assert_engine_matches_jax(jeng, teng, want, got)


def test_port_snapshot_resumes_in_jax(tmp_path):
    jeng, teng = pair()
    for r in range(2):
        teng.run_round(r)
    CheckpointManager(str(tmp_path)).save(TAG, teng.states, teng.host, 2,
                                          layout=LAYOUT, extra=EXTRA)
    states, host, start, tracking = JaxManager(str(tmp_path)) \
        .restore_sharded(TAG, jeng.states, 0, N, expected_extra=EXTRA)
    assert start == 2 and tracking is None
    jeng.states = jax.tree.map(jnp.asarray, states)
    jeng.host = host
    selected = teng.select_clients()
    want = jeng.run_round(2, selected=selected)
    got = teng.run_round(2, selected=selected)
    _assert_engine_matches_jax(jeng, teng, want, got)


def _data():
    clients = synthetic_clients(n_clients=N, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, device="cpu")


FAULTS = dict(attack=AttackSpec(kind="noise", strength=0.2, start_round=1),
              chaos=ChaosSpec(dropout_p=0.2, straggler_p=0.1, crash_p=0.5,
                              broadcast_loss_p=0.1),
              elastic=ElasticSpec(leave_p=0.2, join_p=0.5, preempt_p=0.1))


@pytest.mark.parametrize("faults,chunk,tie_break", [
    ({}, 2, False), (FAULTS, 2, True), (FAULTS, 3, False), ({}, 32, True)])
def test_killed_and_resumed_run_is_the_uninterrupted_run(tmp_path, faults,
                                                         chunk, tie_break):
    """3 rounds, then a fresh process resumes to 5, against 5 rounds at
    once: the same rounds, states, counters and curve, bit for bit."""
    cfg = port_cfg(tie_break=tie_break, num_rounds=5, num_participants=0.75,
                   fused_schedule_chunk=chunk)
    data = _data()

    def run(rounds, resume):
        return run_combination(cfg.replace(num_rounds=rounds), data, N,
                               "hybrid", "mse_avg", 0, resume=resume,
                               early_stop=GlobalEarlyStop(patience=99),
                               **faults)
    whole = run(5, None)
    mgr = CheckpointManager(str(tmp_path))
    first = run(3, mgr)
    assert first["rounds_run"] == 3
    assert json.load(open(tmp_path / f"{TAG}.pod.json"))["round_index"] == 3
    rest = run(5, mgr)
    assert rest["rounds_run"] == 2
    for got, want in zip(first["rounds"] + rest["rounds"], whole["rounds"]):
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.crashed_aggregator == want.crashed_aggregator
        assert got.members == want.members
        np.testing.assert_array_equal(got.client_metrics,
                                      want.client_metrics)
    assert_same_states(rest["engine"].states, whole["engine"].states)
    assert rest["aggregation_count"] == whole["aggregation_count"]
    np.testing.assert_array_equal(rest["final_metrics"],
                                  whole["final_metrics"])
    curve = np.load(tmp_path / f"{TAG}.pod.tracking.npz")["tracking"]
    assert curve.shape == (N, 5 * cfg.epochs, 3)


def test_elastic_signature_mismatch_is_refused_by_name(tmp_path):
    data = _data()
    cfg = port_cfg(num_rounds=2)
    mgr = CheckpointManager(str(tmp_path))
    spec = ElasticSpec(leave_p=0.3, join_p=0.6)
    run_combination(cfg, data, N, "hybrid", "avg", 0, resume=mgr,
                    elastic=spec)
    extra = mgr.extra("hybrid_avg_run0")
    assert extra["elastic"] == spec.signature()
    assert len(extra["elastic_generation"]) == N
    with pytest.raises(ValueError, match="elastic"):
        run_combination(cfg.replace(num_rounds=3), data, N, "hybrid", "avg",
                        0, resume=mgr,
                        elastic=ElasticSpec(leave_p=0.1, join_p=0.6))
    # a snapshot with no recorded timeline was written without churn
    path = tmp_path / "hybrid_avg_run0.pod.json"
    meta = json.load(open(path))
    for key in ("elastic", "elastic_generation"):
        meta["extra"].pop(key)
    json.dump(meta, open(path, "w"))
    with pytest.raises(ValueError, match="elastic"):
        run_combination(cfg.replace(num_rounds=3), data, N, "hybrid", "avg",
                        0, resume=mgr, elastic=spec)
    out = run_combination(cfg.replace(num_rounds=3), data, N, "hybrid",
                          "avg", 0, resume=mgr)
    assert out["rounds_run"] == 1


def test_restore_refuses_a_foreign_layout(tmp_path):
    eng = port_engine()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("t", eng.states, HostState.create(N), 1, layout=LAYOUT)
    assert mgr.exists("t") and not mgr.exists("u")
    from fedmse_tpu_torch.models.flat import ParamLayout
    with pytest.raises(ValueError, match="of shape"):
        mgr.restore("t", layout=ParamLayout(16, 9, 3), device="cpu")
    os.replace(tmp_path / "t.podshard0of1.npz", tmp_path / "keep.npz")
    np.savez(tmp_path / "t.podshard0of1.npz", other=np.zeros(1))
    with pytest.raises(ValueError, match="lacks state leaves"):
        mgr.restore("t", layout=LAYOUT, device="cpu")
    os.replace(tmp_path / "keep.npz", tmp_path / "t.podshard0of1.npz")
    mgr.save("t", eng.states, HostState.create(N), 1, layout=LAYOUT,
             tracking=np.ones((N, 2, 3)))
    mgr.save("t", eng.states, HostState.create(N), 2, layout=LAYOUT)
    assert mgr.restore("t", layout=LAYOUT, device="cpu")[3] is None
    assert sorted(os.listdir(tmp_path)) == ["t.pod.json",
                                            "t.podshard0of1.npz"]


def test_snapshot_hook_needs_the_serial_loop():
    with pytest.raises(ValueError, match="serial"):
        run_pipelined_schedule(port_engine(), 0, 2, 1, lambda r, s: None,
                               pipelined=True, on_chunk=lambda n: None)


def test_cli_resume_runs_serial_and_continues(tmp_path, caplog):
    from fedmse_tpu_torch.federation import pipeline as pipeline_mod
    from fedmse_tpu_torch.main import main
    rng = np.random.default_rng(0)
    for k in range(1, N + 1):
        for split, n, shift in (("normal", 80, 0.0), ("abnormal", 30, 4.0),
                                ("test_normal", 15, 0.0)):
            d = tmp_path / "shards" / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(shift, 1.0, (n, 12)),
                       delimiter=",")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(DatasetConfig.for_client_dirs(
        str(tmp_path / "shards"), N).to_json()))
    seen = []
    real = pipeline_mod.run_pipelined_schedule

    def spy(*args, **kw):
        seen.append(kw["pipelined"])
        return real(*args, **kw)

    common = ["--dataset-config", str(cfg_path), "--device", "cpu",
              "--model-types", "hybrid", "--update-types", "avg",
              "--network-size", str(N), "--dim-features", "12",
              "--epochs", "1", "--batch-size", "8", "--no-save",
              "--checkpoint-dir", str(tmp_path / "c"),
              "--resume-dir", str(tmp_path / "r"),
              "--experiment-name", "t2"]
    import fedmse_tpu_torch.main as driver
    driver.run_pipelined_schedule = spy
    try:
        with caplog.at_level(logging.WARNING):
            main(common + ["--num-rounds", "1"])
            out = main(common + ["--num-rounds", "3"])
    finally:
        driver.run_pipelined_schedule = real
    assert seen == [False, False]
    assert len(out["results"]["hybrid/avg/run0"]["round_times"]) == 2
    assert any("--resume-dir disables fused_pipeline" in r.getMessage()
               for r in caplog.records)
