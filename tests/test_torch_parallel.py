"""The port's client mesh end to end (fedmse_tpu_torch/parallel/, the
sharded round, --use-mesh, the meshed serving engine), against the JAX
package's (tests/test_parallel.py is the counterpart; its
test_graft_entry_dryrun has none: the port has no graft entry).

The port's side runs in W gloo ranks on the CPU (tests/torch_mesh_jobs.py
`session`, one launch per world size: tests/torch_mesh_common.py); the
JAX side here on `client_mesh(W)` of the conftest's 8 virtual devices.
Held:

  * the sharded round at W = 2 (10 clients) and W = 4 (10 clients padded
    to 12): every rank's results the same bits; against the port's dense
    run (the tie-break off) the same selections and aggregators and
    round-1 params within 1e-6; against the JAX engine sharded on
    client_mesh(W) from the JAX init, the same selections and aggregators,
    round-1 params within 1e-5 and the final AUC within 2e-3;
  * the fault hooks, clustering, the pipelined loop's mid-chunk stop and
    the quantized merge on 2 ranks;
  * world 1: --use-mesh is the plain run bit for bit, an explicit
    one-rank mesh is the plain engine, and `initialize()` with no
    configuration stays alone (a configured launch that cannot join
    raises);
  * the per-phase round on the mesh (`fused=False`, `profile=True`,
    metric='time'): against the port's dense per-phase round, the
    sharded fused round (bit for bit) and the JAX per-phase engine on
    client_mesh(W); the tie-break's fleet-wide draws, a second voter call
    under the quota, each rank's phase seconds and kNN banks, and the
    driver's `--use-mesh --fused-rounds false --resume-dir`;
  * the driver under a 2-rank launch (only rank 0 writes), the meshed
    serving engine and its continuous front, `plan_merge`'s cache.
"""

import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import torch_mesh_jobs as jobs
from torch_mesh_common import (TESTS, assert_tree_equal, close,
                               rank_session, write_dataset)
from fedmse_tpu.federation.aggregation import make_aggregate_fn as jax_agg
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.parallel import client_mesh as jax_client_mesh
from fedmse_tpu.parallel import pad_to_multiple as jax_pad
from fedmse_tpu.parallel import shard_clients as jax_shard_clients
from fedmse_tpu_torch.federation import RoundEngine
from fedmse_tpu_torch.federation.fused import FusedRound, ShardedFusedRound
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.ops import graphs
from fedmse_tpu_torch.parallel import (ClientMesh, allgather_blocks,
                                       allgather_tree_sum, pad_to_multiple,
                                       shard_clients, uniform_decision)
from fedmse_tpu_torch.parallel.launch import spawn
from fedmse_tpu_torch.parallel.multihost import initialize
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(1)

WORLDS = (2, 4)


@pytest.fixture(scope="session")
def sessions(tmp_path_factory):
    return {w: rank_session(tmp_path_factory, w) for w in WORLDS}


def _ranks(sessions, w):
    return sessions[w][0]


def _strip(results):
    return [{k: v for k, v in r.items() if k != "backend"} for r in results]


# ---- placement and the pure arithmetic ---- #

def test_pad_to_multiple():
    for n, m in ((10, 4), (12, 4), (1, 8), (50, 8), (7, 1)):
        assert pad_to_multiple(n, m) == jax_pad(n, m)


def test_shard_clients_places_leading_axis():
    tree = {"a": torch.arange(24.).view(12, 2), "b": np.arange(12)}
    for rank in range(4):
        mesh = ClientMesh(4, rank, torch.device("cpu"), "gloo")
        out = shard_clients(tree, mesh)
        assert torch.equal(out["a"], tree["a"][3 * rank:3 * rank + 3])
        assert out["b"].tolist() == list(range(3 * rank, 3 * rank + 3))


# ---- the merge against the JAX package's auto-partitioned einsum ---- #

@pytest.mark.parametrize("update_type", ["avg", "mse_avg"])
def test_shardmap_aggregate_matches_jit(sessions, update_type):
    ranks = _ranks(sessions, 2)
    merged = ranks[0]["merges"][f"shard_map/{update_type}"][0]
    params, sel, dev, _ = jobs.merge_inputs(8)
    mesh = jax_client_mesh(2)
    tree = jax.tree.map(np.asarray, jobs.LAYOUT.tree(torch.from_numpy(
        params)))
    jm, jw = jax_agg(jax_make_model("hybrid", *jobs.DIMS, 3.0),
                     update_type)(jax_shard_clients(tree, mesh),
                                  jax_shard_clients(jnp.asarray(sel), mesh),
                                  jnp.asarray(dev))
    want = jobs.LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32))[None],
        jm)).numpy()[0]
    close(merged, want, 1e-6)
    close(np.concatenate([r["merges"][f"shard_map/{update_type}"][1]
                          for r in ranks]), np.asarray(jw), 1e-6)


# ---- the sharded round ---- #

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_round_matches_single_device(sessions, world):
    got = _ranks(sessions, world)[0]["rounds"]["einsum"]
    dense = jobs.run_engine(None, jobs.config(), pad_to=-(-10 // world)
                            * world)
    for a, b in zip(got["results"], dense["results"]):
        assert a["selected"] == b["selected"]
        assert a["aggregator"] == b["aggregator"]
    close(got["params1"], dense["params1"], 1e-6)
    assert abs(np.nanmean(got["final"]) - np.nanmean(dense["final"])) \
        <= 2e-3


@pytest.mark.parametrize("world", WORLDS)
def test_full_round_on_global_mesh(sessions, world):
    """The port's sharded round from the JAX init against the JAX engine
    sharded on client_mesh(W)."""
    ranks, jax_runs = sessions[world]
    jax_results, jax_p1 = jax_runs["fused"]
    got = ranks[0]["jax_init"]
    for a, b in zip(got["results"], jax_results):
        assert a["selected"] == list(b["selected"])
        assert a["aggregator"] == b["aggregator"]
    close(got["params1"], jax_p1, 1e-5)
    assert abs(np.nanmean(got["results"][-1]["client_metrics"])
               - np.nanmean(jax_results[-1]["client_metrics"])) <= 2e-3


@pytest.mark.parametrize("world", WORLDS)
def test_two_process_federation(sessions, world):
    """Every rank's round results, states and evaluation: the same bits."""
    ranks = _ranks(sessions, world)
    for r in ranks[1:]:
        for key in ("rounds", "jax_init"):
            assert_tree_equal(r[key], ranks[0][key], key)


def test_fifty_clients_on_four_ranks(sessions):
    for r in _ranks(sessions, 4):
        res = r["fifty"]["results"][0]
        assert res["client_metrics"].shape == (50,)
        assert np.all(np.isfinite(res["client_metrics"]))
        assert len(res["selected"]) == 10
        assert res["aggregator"] in res["selected"]
        assert r["fifty"]["compact"] is False


def test_two_process_midchunk_early_stop(sessions):
    """The pipelined loop stops inside a chunk on every rank alike, rewinds
    and replays: the dense run's rounds, quota and states."""
    ranks = _ranks(sessions, 2)
    assert_tree_equal(ranks[1]["early_stop"], ranks[0]["early_stop"])
    dense = jobs.early_stop_run(None)
    got = ranks[0]["early_stop"]
    assert [r["round_index"] for r in got["seen"]] == [0, 1, 2, 3]
    for a, b in zip(got["seen"], dense["seen"]):
        assert a["selected"] == b["selected"]
        assert a["aggregator"] == b["aggregator"]
    np.testing.assert_array_equal(got["agg_count"], dense["agg_count"])
    close(got["params"], dense["params"], 1e-5)


def test_two_process_hostlocal_and_quantized(sessions):
    """The quantized round on 2 ranks (2 groups): the ranks agree, the
    backend is recorded, and the round stays within the quality bar."""
    ranks = _ranks(sessions, 2)
    q = ranks[0]["rounds"]["quantized"]
    assert_tree_equal(ranks[1]["rounds"]["quantized"], q)
    assert {r["backend"] for r in q["results"]} == {"quantized"}
    np.testing.assert_allclose(
        q["results"][0]["client_metrics"],
        ranks[0]["rounds"]["einsum"]["results"][0]["client_metrics"],
        atol=2e-3)


def test_two_process_fault_hooks_match_dense(sessions):
    """Chaos and elastic membership on 2 ranks: the dense run's effective
    cohorts, crashes, re-elections and members; round-1 params within
    1e-6."""
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    ranks = _ranks(sessions, 2)
    got = ranks[0]["hooks"]
    assert_tree_equal(ranks[1]["hooks"], got)
    dense = jobs.run_engine(
        None, jobs.config(num_rounds=4), rounds=4,
        chaos=ChaosSpec(dropout_p=0.2, straggler_p=0.1, crash_p=0.5,
                        broadcast_loss_p=0.2),
        elastic=ElasticSpec(leave_p=0.2, join_p=0.5, preempt_p=0.1))
    for a, b in zip(got["results"], dense["results"]):
        for key in ("selected", "aggregator", "effective",
                    "crashed_aggregator", "members"):
            assert a[key] == b[key], key
    close(got["params1"], dense["params1"], 1e-6)


def test_two_process_clustered_quantized_merge(sessions):
    """K = 2 with personalization and a refit, merged by the quantized
    backend on 2 ranks: the ranks agree, and the final AUC is within 2e-3
    of the dense clustered run's."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    ranks = _ranks(sessions, 2)
    got = ranks[0]["clustered"]
    assert_tree_equal(ranks[1]["clustered"], got)
    dense = jobs.run_engine(None, jobs.config(num_rounds=4), rounds=4,
                            cluster=ClusterSpec(k=2, personalize=True,
                                                refit_every=2))
    assert {r["backend"] for r in got["results"]} == {"quantized"}
    assert abs(np.nanmean(got["final"]) - np.nanmean(dense["final"])) \
        <= 2e-3


# ---- the per-phase round over the mesh ---- #

PHASE_KEYS = {"train", "vote", "aggregate", "verify", "evaluate"}
RESULT_FIELDS = ("selected", "aggregator", "client_metrics",
                 "verification_results", "mse_scores", "agg_weights",
                 "tracking", "min_valid", "backend")


def _pad(world):
    return -(-jobs.N_CLIENTS // world) * world


def _fields(results):
    return [{k: r[k] for k in RESULT_FIELDS} for r in results]


def _elections(run):
    return [(r["selected"], r["aggregator"]) for r in run["results"]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", ["einsum", "shard_map"])
def test_sharded_per_phase_matches_dense_per_phase(sessions, world,
                                                   backend):
    """The sharded per-phase round against the port's dense one: the
    same selections and elections and the final evaluation's bits;
    round-1 params within 1e-6 scaled (the exact merge sums the ranks'
    partials in rank order, the dense merge is one product: the
    summation order differs in the last bits)."""
    got = _ranks(sessions, world)[0]["phase"][backend]
    dense = jobs.run_engine(None, jobs.config(), pad_to=_pad(world),
                            fused=False)
    assert _elections(got) == _elections(dense)
    close(got["params1"], dense["params1"], 1e-6)
    np.testing.assert_array_equal(got["final"], dense["final"])
    assert {r["backend"] for r in got["results"]} == {backend}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_per_phase_quantized_within_codec(sessions, world):
    """The quantized per-phase round, as the fused tests hold it: round
    1's aggregator the exact round's, its metrics within 2e-3."""
    phase = _ranks(sessions, world)[0]["phase"]
    q, exact = phase["quantized"]["results"], phase["einsum"]["results"]
    assert q[0]["aggregator"] == exact[0]["aggregator"]
    np.testing.assert_allclose(q[0]["client_metrics"],
                               exact[0]["client_metrics"], atol=2e-3)
    assert {r["backend"] for r in q} == {"quantized"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", ["einsum", "shard_map", "quantized",
                                     "auto"])
def test_sharded_per_phase_is_sharded_fused_bits(sessions, world, backend):
    """The sharded per-phase round is the sharded fused round bit for
    bit (the same kernels on the same blocks, the same gathers): results,
    round-1 and final params, the final evaluation."""
    r = _ranks(sessions, world)[0]
    phase, fused = r["phase"][backend], r["rounds"][backend]
    assert_tree_equal(_fields(phase["results"]), _fields(fused["results"]))
    for key in ("params1", "params", "final"):
        np.testing.assert_array_equal(phase[key], fused[key], err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_per_phase_matches_jax_per_phase(sessions, world):
    """From the JAX init, against the JAX per-phase engine sharded on
    client_mesh(W): the same selections, elections and backend, round-1
    params within 1e-5 scaled, the final AUC within 2e-3."""
    ranks, jax_runs = sessions[world]
    jax_results, jax_p1 = jax_runs["phase"]
    got = ranks[0]["phase_jax_init"]
    for a, b in zip(got["results"], jax_results, strict=True):
        assert a["selected"] == list(b["selected"])
        assert a["aggregator"] == b["aggregator"]
        assert a["backend"] == b["backend"] == "einsum"
    close(got["params1"], jax_p1, 1e-5)
    assert abs(np.nanmean(got["results"][-1]["client_metrics"])
               - np.nanmean(jax_results[-1]["client_metrics"])) <= 2e-3


@pytest.mark.parametrize("world", WORLDS)
def test_per_phase_ranks_agree(sessions, world):
    """Every rank's per-phase results, states and evaluations: the same
    bits (the phase seconds aside: each rank's own clock)."""
    ranks = _ranks(sessions, world)
    for r in ranks[1:]:
        for key in ("phase", "phase_jax_init", "phase_tie", "quota"):
            assert_tree_equal(r[key], ranks[0][key], key)
        assert_tree_equal(r["profiled"]["results"],
                          ranks[0]["profiled"]["results"])
        for key in ("round", "final"):  # latencies gathered from the ranks
            np.testing.assert_array_equal(r["latency"][key],
                                          ranks[0]["latency"][key])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_per_phase_tie_break_draws_fleet_wide(sessions, world):
    """The tie-break on: each rank jitters its block with its rows of the
    fleet's draw, so round 1's winning scores are the dense run's bits
    (a rank that drew its own n uniforms would jitter every block
    alike), and every election is the dense run's."""
    from fedmse_tpu_torch.config import CompatConfig
    got = _ranks(sessions, world)[0]["phase_tie"]
    dense = jobs.run_engine(
        None, jobs.config(compat=CompatConfig(vote_tie_break=True)),
        pad_to=_pad(world), fused=False)
    assert _elections(got) == _elections(dense)
    np.testing.assert_array_equal(got["results"][0]["mse_scores"],
                                  dense["results"][0]["mse_scores"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_quota_needs_second_voter_call(sessions, world):
    """The first voter's candidates all at the quota: every rank makes a
    second voter call (and its gather) and elects the first voter, as the
    dense round does with the same scores."""
    dense = jobs.quota_run(None, _pad(world))
    assert dense["voter_calls"] == 2
    assert dense["aggregator"] == dense["selected"][0]
    for r in _ranks(sessions, world):
        q = r["quota"]
        assert q["selected"] == dense["selected"]
        assert (q["aggregator"], q["voter_calls"]) == (
            dense["aggregator"], dense["voter_calls"])
        np.testing.assert_array_equal(q["scores"], dense["scores"])


@pytest.mark.parametrize("world", WORLDS)
def test_profile_over_ranks_times_every_phase(sessions, world):
    """run_combination(profile=True) over the mesh: every round on every
    rank has the JAX phase keys, each finite and > 0; the rounds are the
    dense profiled run's elections."""
    dense = jobs.profiled_run(None, _pad(world))
    assert set(dense["phase_seconds"][0]) == PHASE_KEYS
    for r in _ranks(sessions, world):
        prof = r["profiled"]
        assert len(prof["phase_seconds"]) == jobs.config().num_rounds
        for secs in prof["phase_seconds"]:
            assert set(secs) == PHASE_KEYS
            assert all(np.isfinite(v) and v > 0 for v in secs.values())
        assert _elections(prof) == _elections(dense)
        np.testing.assert_array_equal(prof["final"], dense["final"])


@pytest.mark.parametrize("world", WORLDS)
def test_time_metric_over_ranks_draws_own_banks(sessions, world):
    """metric='time' (kNN score) on a sharded per-phase engine: [n_real]
    finite positive latencies, each rank's client i scored on the bank
    drawn for its global id lo + i (the warm-up call, then every
    repetition)."""
    from fedmse_tpu_torch.knn.bank import bank_priorities
    for r in _ranks(sessions, world):
        lat = r["latency"]
        for out in (lat["round"], lat["final"]):
            assert out.shape == (jobs.N_CLIENTS,)
            assert np.all(np.isfinite(out)) and np.all(out > 0)
        lo, hi = lat["block"]
        want = bank_priorities(0, _pad(world), lat["rows"]).numpy()
        seen = lat["priorities"]
        reps, left = divmod(len(seen) - 1, hi - lo)
        assert left == 0 and reps >= 1
        np.testing.assert_array_equal(seen[0][0], want[lo])
        for i in range(hi - lo):
            for k in range(reps):
                np.testing.assert_array_equal(seen[1 + i * reps + k][0],
                                              want[lo + i])


def test_driver_use_mesh_per_phase_resumes(sessions, tmp_path):
    """`main --use-mesh --fused-rounds false --resume-dir` on 2 ranks: one
    round, then a resumed second; rank 0 alone writes, both ranks report
    the same results, and the resumed run's final evaluation is the
    dense per-phase driver's two rounds."""
    from fedmse_tpu_torch.main import main
    ranks = _ranks(sessions, 2)
    dataset = os.path.join(ranks[0]["root"], "driver", "shards",
                           "config.json")
    outs = [r["phase_driver"] for r in ranks]
    for run in ("first", "resumed"):
        assert outs[0][run]["summary_path"] is not None
        assert outs[1][run]["summary_path"] is None
        assert outs[0][run]["final"] == outs[1][run]["final"]
        assert outs[0][run]["backend"] == ["einsum"]
    dense = main(jobs.driver_argv(dataset, str(tmp_path / "dense"))
                 + ["--fused-rounds", "false"])
    want = list(dense["results"].values())[0]["final_metrics"]
    np.testing.assert_array_equal(outs[0]["resumed"]["final"][0], want)


# ---- world 1 ---- #

def test_placement_helpers_world_one(mesh8):
    """At world 1 the fetch helpers copy to the host (the async one through
    a harvest call), `replicate` places the whole value, and the tier's
    block arithmetic is the JAX package's single-process one."""
    from fedmse_tpu.parallel import mesh_process_indices as jax_procs
    from fedmse_tpu.parallel import my_tier_block as jax_block
    from fedmse_tpu_torch.parallel import (host_fetch, host_fetch_async,
                                           local_shard_rows,
                                           mesh_process_indices,
                                           my_tier_block, replicate)
    tree = {"a": torch.arange(6.0).view(3, 2), "b": [torch.ones(2)]}
    for got in (host_fetch(tree, ClientMesh()),
                host_fetch_async(tree, ClientMesh())(),
                local_shard_rows(tree)):
        np.testing.assert_array_equal(got["a"], tree["a"].numpy())
        np.testing.assert_array_equal(got["b"][0], np.ones(2))
    placed = replicate(tree, ClientMesh())
    assert torch.equal(placed["a"], tree["a"])
    assert placed["a"].data_ptr() != tree["a"].data_ptr()
    assert mesh_process_indices(1) == jax_procs(mesh8)
    assert my_tier_block(11, 1, 0) == jax_block(11, mesh8)
    assert my_tier_block(11, 3, 2) == (8, 11)


def test_multihost_helpers_single_process():
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": np.ones(4, np.float32)}
    assert allgather_tree_sum(tree) is tree
    local = np.arange(10).reshape(5, 2)
    assert allgather_blocks(local, [(0, 5)], [0]) is local
    assert uniform_decision(True) is True
    assert uniform_decision(False) is False


def test_multihost_initialize_is_safe_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(device="cpu") is False
    assert not dist.is_initialized()


def test_configured_launch_that_fails_raises(tmp_path):
    """A launch configured for 2 ranks whose peer never comes raises; it
    never runs alone."""
    with pytest.raises(Exception):
        initialize(store=dist.FileStore(str(tmp_path / "store"), 2),
                   world_size=2, rank=0, device="cpu", timeout_s=2.0)
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_launch_without_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize(store=dist.FileStore(str(tmp_path / "s"), 1),
                   world_size=1, rank=0, device="cuda")


def test_explicit_one_rank_mesh_is_the_plain_engine():
    """A mesh of one rank shards nothing: the plain FusedRound (its bodies
    run no collective) and the plain run's bits."""
    eng = RoundEngine(make_model("hybrid", *jobs.DIMS, 1.0, device="cpu"),
                      jobs.config(), jobs.federation(), 10,
                      ExperimentRngs(run=0), "hybrid", "mse_avg", fused=True,
                      mesh=ClientMesh())
    f = eng.fused_round(1)
    assert type(f) is FusedRound and not isinstance(f, ShardedFusedRound)
    one = jobs.run_engine(ClientMesh(), jobs.config())
    plain = jobs.run_engine(None, jobs.config())
    assert_tree_equal(one, plain)


def test_collective_outside_a_body_runs_now():
    src = torch.arange(3.0)
    out = graphs.collective(src, lambda s: torch.empty((2, 3)),
                            lambda s, d: d.copy_(torch.stack([s, 2 * s])))
    assert out.tolist() == [[0, 1, 2], [0, 2, 4]]


def test_use_mesh_world_one_is_plain_run(tmp_path):
    from fedmse_tpu_torch.main import main
    cfg_path = write_dataset(str(tmp_path / "shards"))
    a = main(jobs.driver_argv(cfg_path, str(tmp_path / "a"))
             + ["--use-mesh"])
    b = main(jobs.driver_argv(cfg_path, str(tmp_path / "b")))
    for run in (a, b):
        for v in run["results"].values():
            v.pop("round_times")  # wall clocks
    assert a["results"] == b["results"]
    assert a["best_metrics"] == b["best_metrics"]


def test_driver_use_mesh_two_ranks(tmp_path):
    """`python -m fedmse_tpu_torch.main --use-mesh --device cpu` on 2 gloo
    ranks: 5 clients padded to 6; rank 0 alone writes; both ranks report
    the same results; the run lands within 2e-3 of the plain one."""
    from fedmse_tpu_torch.main import main
    cfg_path = write_dataset(str(tmp_path / "shards"))
    ckpt = str(tmp_path / "mesh")
    outs = spawn(2, "torch_mesh_jobs:driver",
                 {"root": str(tmp_path),
                  "argv": jobs.driver_argv(cfg_path, ckpt)
                  + ["--use-mesh"]},
                 device="cpu", workdir=str(tmp_path / "ranks"),
                 timeout_s=300, pythonpath=[TESTS])
    assert outs[0]["summary_path"] is not None
    assert outs[1]["summary_path"] is None
    assert os.path.exists(outs[0]["summary_path"])
    assert outs[0]["final"] == outs[1]["final"]
    assert outs[0]["backend"] == ["einsum"]
    plain = main(jobs.driver_argv(cfg_path, str(tmp_path / "plain")))
    got = np.asarray(outs[0]["final"][0])
    want = np.asarray(list(plain["results"].values())[0]["final_metrics"])
    assert abs(np.nanmean(got) - np.nanmean(want)) <= 2e-3


# ---- serving and the plan ---- #

def test_mesh_sharded_serving_matches_unsharded(sessions):
    """8 gateways on 2 ranks: gateway-sharded, and every row's score the
    unsharded engine's bits, at sharded and small buckets alike; a gateway
    count the ranks do not divide replicates the state."""
    for r in _ranks(sessions, 2):
        s = r["serving"]
        assert s["sharded/f32"] and not s["odd_sharded"]
        for take, (meshed, plain) in s["f32"].items():
            np.testing.assert_array_equal(meshed, plain, err_msg=str(take))


def test_mesh_sharded_serving_bf16_engine(sessions):
    for r in _ranks(sessions, 2):
        for take, (meshed, plain) in r["serving"]["bf16"].items():
            np.testing.assert_array_equal(meshed, plain, err_msg=str(take))


def test_continuous_front_over_meshed_engine(sessions):
    """The continuous front over a gateway-sharded engine, flushing on size
    only (latency_budget_ms=1e9): the unsharded engine's scores."""
    for r in _ranks(sessions, 2):
        got, want = r["serving"]["front"]
        np.testing.assert_array_equal(got, want)


def test_plan_merge_remeasure_skip(sessions):
    """An identical plan_merge call hits the 'merge_plan' entry and skips
    the measurement; another grid measures anew."""
    for r in _ranks(sessions, 2):
        p = r["plan"]
        assert p["first"]["cached"] is False
        assert p["again"]["cached"] is True
        assert p["again"]["chosen"] == p["first"]["chosen"]
        assert p["drift"]["cached"] is False
        assert [c["backend"] for c in p["first"]["candidates"]] == [
            "shard_map", "quantized"]
    assert _ranks(sessions, 2)[0]["plan"]["first"]["chosen"] == \
        _ranks(sessions, 2)[1]["plan"]["first"]["chosen"]


def test_plan_merge_measured_search(sessions):
    p = _ranks(sessions, 2)[0]["plan"]["first"]
    assert p["n_devices"] == 2 and p["k"] == 2
    assert p["merged_elems"] == 2 * jobs.LAYOUT.size
    for c in p["candidates"]:
        assert c["wall_s"] > 0 and c["score_s"] >= c["wall_s"]
    assert p["chosen"] in [{k: c[k] for k in ("backend", "num_groups",
                                              "block_size")}
                           for c in p["candidates"]]


def test_loggers_stay_quiet_off_mesh(caplog):
    """A plain engine with the default backend says nothing of meshes."""
    caplog.set_level(logging.INFO)
    jobs.run_engine(None, jobs.config(), rounds=1)
    assert not [r for r in caplog.records if "mesh" in r.getMessage()]
