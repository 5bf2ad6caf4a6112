"""The port's tier over a client mesh (federation/tiered.py `mesh=` and
`host_sharded=True`, checkpointing/io.py pod snapshots), against the
port's single-process tier and, where the JAX package has them, its
numbers (tests/test_podscale.py, test_tiered.py's mesh slab test).

The 2-rank runs are tests/torch_mesh_jobs.py `run_tier` inside the world-2
session (tests/torch_mesh_common.py): 12 clients, full participation, 3
rounds, rank j tiering rows [6 j, 6 j + 6) when host-sharded. Held:

  * a host-sharded tier of one rank is the plain tier, bit for bit;
  * on 2 ranks every rank's results are the same bits, each rank's host
    tier holds its block of rows (half the plain tier's bytes), and the
    final AUC is within 2e-3 of the single-process tier;
  * the cluster refit cadence is live on the host-sharded tier;
  * the 2-rank pod snapshot (one shard per rank) reassembles at any rows
    and resumes a single-process run, plain or host-sharded;
  * the cohort shards over the mesh without host sharding (every rank
    keeps the whole tier) with the single-process tier's selections;
  * the same 2 ranks named as two hosts run host-sharded whatever
    `host_sharded` says (the JAX tier's rule across processes), with
    per-host selection counts; named as one host, the plain tier;
  * `local_data=True` (each rank stacks only its block) is the full-stack
    host-sharded run bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_mesh_jobs as jobs
from torch_mesh_common import assert_tree_equal, rank_session
from fedmse_tpu_torch.checkpointing import CheckpointManager
from fedmse_tpu_torch.federation.tiered import run_tiered_combination
from fedmse_tpu_torch.parallel import ClientMesh

torch.set_num_threads(1)

TAG = "hybrid_mse_avg_run0"


@pytest.fixture(scope="session")
def session2(tmp_path_factory):
    return rank_session(tmp_path_factory, 2)[0]


def _same_results(a, b):
    for x, y in zip(a["results"], b["results"]):
        assert_tree_equal(x, y)


def test_host_sharded_single_process_bitwise_plain():
    plain = jobs.run_tier(None)
    one = jobs.run_tier(ClientMesh(), host_sharded=True)
    _same_results(one, plain)
    np.testing.assert_array_equal(one["final"], plain["final"])
    np.testing.assert_array_equal(one["params"], plain["params"])
    assert one["rows"] == (0, 12)


def test_cluster_refit_every_is_live_on_tier(session2):
    """refit_every=2 over 4 rounds: the assignment is refitted at round 2
    on every rank (the fit's statistics gathered block by block), as on
    the single-process tier."""
    for r in session2:
        assert r["tier_refit"]["cluster_fitted_round"] == 2
    assert_tree_equal(session2[1]["tier_refit"]["results"],
                      session2[0]["tier_refit"]["results"])
    single = jobs.run_tier(None, cluster_refit=2, rounds=4)
    assert single["cluster_fitted_round"] == 2


def test_two_process_pod_tier_agrees(session2):
    a, b = (r["tier_pod"] for r in session2)
    _same_results(a, b)
    np.testing.assert_array_equal(a["final"], b["final"])
    assert (a["rows"], b["rows"]) == ((0, 6), (6, 12))
    plain = jobs.run_tier(None)
    assert a["host_bytes"] * 2 == plain["host_bytes"]


def test_pod_matches_single_process_auc(session2):
    pod = session2[0]["tier_pod"]
    single = jobs.run_tier(None)
    for a, b in zip(pod["results"], single["results"]):
        assert sorted(a["selected"]) == sorted(b["selected"])
    np.testing.assert_allclose(pod["final"], single["final"], atol=2e-3)
    assert abs(np.nanmean(pod["final"]) - np.nanmean(single["final"])) \
        <= 2e-3


def test_pod_checkpoint_restores_across_layouts(session2):
    """The snapshot the 2 ranks wrote (2 shards of 6 rows) reassembles at
    any rows, and a single-process tier, plain or host-sharded, resumes
    from it with no round left and the pod's federation."""
    mgr = CheckpointManager(session2[0]["root"] + "/ckpt")
    assert mgr.exists(TAG)
    layout = jobs.LAYOUT
    full, host, rnd, _ = mgr.restore(TAG, layout=layout, device="cpu")
    assert rnd == 3
    lo, _, _, _ = mgr.restore(TAG, layout=layout, device="cpu",
                              rows=(0, 6))
    hi, _, _, _ = mgr.restore(TAG, layout=layout, device="cpu",
                              rows=(6, 12))
    mid, _, _, _ = mgr.restore(TAG, layout=layout, device="cpu",
                               rows=(4, 9))
    for f, a, b, m in zip(full.tensors(), lo.tensors(), hi.tensors(),
                          mid.tensors()):
        assert torch.equal(f, torch.cat([a, b]))
        assert torch.equal(f[4:9], m)
    np.testing.assert_array_equal(
        full.params.numpy(),
        np.concatenate([r["tier_pod"]["params"] for r in session2]))
    finals = {}
    for name, kw in (("plain", {}), ("sharded", {"host_sharded": True})):
        cfg = jobs.tier_config(**kw)
        out = run_tiered_combination(
            cfg, jobs.federation(12), 12, "hybrid", "mse_avg", 0,
            mesh=ClientMesh() if kw else None, device="cpu", resume=mgr)
        assert out["round_times"] == []
        finals[name] = np.asarray(out["final_metrics"])
    np.testing.assert_array_equal(finals["plain"], finals["sharded"])
    np.testing.assert_allclose(finals["plain"], session2[0]["tier_pod"][
        "final"], atol=2e-3)


def test_cohort_slab_shards_over_client_mesh(session2):
    """Half participation on 2 ranks without host sharding: every rank
    keeps the whole tier, each runs its lanes of the cohort; the
    selections are the single-process tier's and the round metrics agree
    to float level (the merge's partials sum in another order)."""
    a, b = (r["tier_plain"] for r in session2)
    _same_results(a, b)
    assert a["rows"] == (0, 12) and a["cohort"] == 6
    single = jobs.run_tier(None, ratio=0.5)
    for x, y in zip(a["results"], single["results"]):
        assert x["selected"] == y["selected"]
        assert x["aggregator"] == y["aggregator"]
        np.testing.assert_allclose(x["client_metrics"], y["client_metrics"],
                                   atol=2e-3)


def test_two_host_mesh_forces_host_sharded_tier(session2):
    """A mesh whose ranks name two hosts runs the host-sharded tier with
    host_sharded=False: each rank's host data is its block only, and the
    run is the bits of host_sharded=True on the real mesh."""
    for r in session2:
        two, pod = r["tier_two_hosts"], r["tier_pod"]
        assert two["host_sharded"]
        assert two["rows"] == pod["rows"]
        assert two["host_data_bytes"] == two["block_data_bytes"]
        assert two["host_bytes"] == pod["host_bytes"]
        _same_results(two, pod)
        np.testing.assert_array_equal(two["final"], pod["final"])
        np.testing.assert_array_equal(two["params"], pod["params"])


def test_two_host_mesh_draws_per_host_cohorts(session2):
    """At half participation each host's block contributes
    max(1, int(ratio * block)) clients a round, the JAX tier's per-host
    count (fedmse_tpu/federation/tiered.py, `_sel_counts`), and both
    ranks draw the same cohorts."""
    a, b = (r["tier_two_hosts_half"] for r in session2)
    _same_results(a, b)
    assert a["host_sharded"] and a["blocks"] == [(0, 6), (6, 12)]
    want = [max(1, int(0.5 * (hi - lo))) for lo, hi in a["blocks"]]
    for res in a["results"]:
        sel = np.asarray(res["selected"])
        got = [int(((sel >= lo) & (sel < hi)).sum())
               for lo, hi in a["blocks"]]
        assert got == want


def test_one_host_multi_rank_mesh_keeps_plain_tier(session2):
    for r in session2:
        one, plain = r["tier_one_host"], r["tier_plain"]
        assert not one["host_sharded"] and one["rows"] == (0, 12)
        _same_results(one, plain)
        np.testing.assert_array_equal(one["final"], plain["final"])


def test_local_data_tier_is_full_stack_tier(session2):
    """Each rank stacks only its block (local_data=True): rounds, states
    and the final AUC are the full-stack host-sharded run's bits, and the
    rank's host data is its block's bytes."""
    for r in session2:
        loc, pod = r["tier_local"], r["tier_pod"]
        assert loc["host_data_bytes"] == loc["block_data_bytes"]
        assert loc["host_data_bytes"] == pod["host_data_bytes"]
        _same_results(loc, pod)
        np.testing.assert_array_equal(loc["final"], pod["final"])
        np.testing.assert_array_equal(loc["params"], pod["params"])


def test_local_data_row_count_must_be_the_block():
    """local_data whose row count is not the rank's block is refused by
    name (here one rank's block is the fleet of 12)."""
    from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    with pytest.raises(ValueError, match="carries 6 client rows; this "
                       "rank's block needs 12"):
        data = jobs.federation(12)
        half = type(data)(**{k: v[:6] if k != "dev_x" else v
                             for k, v in vars(data).items()})
        TieredRoundEngine(make_model("hybrid", *jobs.DIMS, 3.0,
                                     device="cpu"), jobs.tier_config(),
                          half, 12, ExperimentRngs(run=0), "hybrid",
                          "mse_avg", mesh=ClientMesh(), host_sharded=True,
                          local_data=True, device="cpu")
