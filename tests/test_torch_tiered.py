"""The port's tiered state layout (fedmse_tpu_torch/federation/tiered.py,
state.TieredClientStore, elastic.apply_membership_transitions,
pipeline.PrefetchedCohort / TieredStats, stack_clients(client_range=),
`--state-layout tiered`) on the CPU, at width 16 / 8 / 3:

  * the tier's chunked init is the dense init row for row, bit for bit,
    and leaves the generator where the dense init does;
  * at full participation (C == N) the tiered engine is the dense fused
    engine bit for bit (states, round results, the driver's artifacts),
    with the tie-break on and off;
  * the prefetched loop (stale rows patched from the last round's output)
    is the serial loop bit for bit; padding the client axis changes
    nothing; below full participation the cohort's training curves are
    the dense engine's and the other clients' round metrics NaN;
  * against the JAX TieredRoundEngine from the JAX tier's init, 3 rounds
    at num_participants 0.5, tie-break off (clean, attacked, chaos and
    elastic, the JAX masks fed to the port): selections and aggregators
    equal, states within 1e-5 scale-normalized, round metrics within 1e-5
    and NaN where the JAX metrics are NaN;
  * apply_membership_transitions against the JAX one on the same rows
    (<= 1e-6), flat and cluster-scoped;
  * memory accounting, checkpoints both ways, the guards (mesh,
    host-sharded tiers, an active red team, metric='time', the layouts)
    and the CLI.
"""

import glob
import json
import logging
import os
import types

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
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec
from fedmse_tpu.federation import TieredRoundEngine as JaxTiered
from fedmse_tpu.federation import make_poison_fn as jax_make_poison_fn
from fedmse_tpu.federation.elastic import \
    apply_membership_transitions as jax_transitions
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.chaos import (ChaosMasks, ChaosSpec, make_chaos_masks,
                                    reelection_draws)
from fedmse_tpu_torch.chaos.masks import chaos_columns, reelection_columns
from fedmse_tpu_torch.checkpointing import CheckpointManager
from fedmse_tpu_torch.cluster import ClusterSpec
from fedmse_tpu_torch.config import CompatConfig, DatasetConfig
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data import (pad_federated_data, stack_clients,
                                   stack_dims, synthetic_clients)
from fedmse_tpu_torch.federation import (RoundEngine,
                                         client_states_from_numpy,
                                         init_client_states)
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.federation.elastic import (
    ElasticSpec, MembershipMasks, apply_membership_transitions)
from fedmse_tpu_torch.federation.pipeline import TieredStats
from fedmse_tpu_torch.federation.state import (TieredClientStore,
                                               TieredShardStore,
                                               client_states_to_numpy,
                                               dense_state_bytes)
from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
from fedmse_tpu_torch.main import main
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.redteam import RedteamSpec
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import assert_same_states

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N = 6
BASE = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=N,
            epochs=2)
DATA = dict(n_clients=N, dim=16, n_normal=240, n_abnormal=120, seed=0)


def _cfg(tie_break=False, **kw):
    return ExperimentConfig(**{**BASE, **kw},
                            compat=CompatConfig(vote_tie_break=tie_break))


def _data(pad_to=None, seed=0):
    clients = synthetic_clients(**{**DATA, "seed": seed})
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         device="cpu")


def _model(model_type="hybrid"):
    return make_model(model_type, *DIMS, 5.0, device="cpu")


def _tiered(cfg, data=None, update_type="mse_avg", **kw):
    return TieredRoundEngine(
        _model(), cfg, _data() if data is None else data, n_real=N,
        rngs=ExperimentRngs(run=0), model_type="hybrid",
        update_type=update_type, device="cpu", **kw)


def _dense(cfg, data=None, update_type="mse_avg", **kw):
    return RoundEngine(_model(), cfg, _data() if data is None else data,
                       n_real=N, rngs=ExperimentRngs(run=0),
                       model_type="hybrid", update_type=update_type,
                       fused=True, **kw)


def _run(engine, rounds, start=0):
    out = []
    engine.run_rounds(start, rounds, lambda r, s: out.append(r) or False)
    return out


def _same_round(got, want):
    """Two RoundResults equal bit for bit (NaN where NaN)."""
    for field in ("round_index", "selected", "aggregator",
                  "verification_results", "effective",
                  "crashed_aggregator", "members"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("client_metrics", "mse_scores", "agg_weights", "tracking",
                  "min_valid", "metrics_full", "divergence", "generations"):
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


# ------------------------------------------------------- the host tier ----

@pytest.mark.parametrize("chunk", [1, 4, 11, 4096])
def test_tier_init_rows_are_the_dense_init(chunk):
    gen_a = torch.Generator().manual_seed(7)
    gen_b = torch.Generator().manual_seed(7)
    dense = init_client_states(_model(), 11, gen_a, device="cpu")
    tier = TieredClientStore.create(_model(), 11, gen_b, init_chunk=chunk)
    assert_same_states(tier.host, dense)
    assert torch.equal(torch.rand(5, generator=gen_a),
                       torch.rand(5, generator=gen_b))


@pytest.mark.parametrize("rows", [(0, 3), (2, 6), (4, 9)])
def test_stack_clients_client_range_is_rows_of_the_full_stack(rows):
    clients = synthetic_clients(**{**DATA, "n_normal": 60, "n_abnormal": 30})
    dev_x = np.concatenate([c.dev_raw for c in clients])[:50].astype(
        np.float32)
    full = stack_clients(clients, dev_x, 12, pad_clients_to=9,
                         device="cpu")
    part = stack_clients(clients, dev_x, 12, client_range=rows,
                         dims=stack_dims(clients, 12, 9), device="cpu")
    for name in ("train_xb", "train_mb", "valid_xb", "valid_mb", "valid_x",
                 "valid_m", "test_x", "test_m", "test_y", "client_mask"):
        assert torch.equal(getattr(part, name),
                           getattr(full, name)[rows[0]:rows[1]]), name
    assert torch.equal(part.dev_x, full.dev_x)
    with pytest.raises(ValueError, match="client_range"):
        stack_clients(clients, dev_x, 12, client_range=(0, 10),
                      pad_clients_to=9, device="cpu")


def test_slab_bytes_scale_with_cohort_and_gather_pads_zero_rows():
    tier = TieredClientStore.create(_model(), 4096,
                                    torch.Generator().manual_seed(0))
    b64, b512 = tier.slab_bytes(64), tier.slab_bytes(512)
    assert b512 == 8 * b64
    slab = tier.gather(np.arange(512))
    assert sum(t.numel() * t.element_size()
               for t in slab.tensors()) == b512
    assert dense_state_bytes(_model(), 4096) == tier.host_bytes()
    assert tier.host_bytes() >= 8 * b512
    pads = tier.gather(np.array([3, -1, 5]))
    assert torch.equal(pads.params[0], tier.host.params[3])
    assert not pads.params[1].any() and not pads.hist_seen[1]
    # a scatter writes the real lanes back and drops the pad lane
    pads.params += 1.0
    tier.scatter(np.array([3, -1, 5]), pads)
    assert torch.equal(tier.host.params[5], pads.params[2])


def test_100k_init_stays_on_the_host():
    n = 100_000
    model = make_model("hybrid", 6, 4, 2, 5.0, device="cpu")
    tier = TieredClientStore.create(model, n,
                                    torch.Generator().manual_seed(1),
                                    init_chunk=8192)
    assert all(t.device.type == "cpu" and t.shape[0] == n
               for t in tier.host.tensors())
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == 0
    assert dense_state_bytes(model, n) / tier.slab_bytes(512) >= 100


# ------------------------------------------- against the dense engine ----

KNN = dict(score_kind="knn", knn_bank_size=16, knn_k=3)


@pytest.mark.parametrize("tie_break, extra", [(False, {}), (True, {}),
                                              (True, KNN)])
def test_full_participation_is_the_dense_engine(tie_break, extra):
    cfg = _cfg(tie_break=tie_break, num_participants=1.0, num_rounds=3,
               **extra)
    dense = _dense(cfg)
    want = dense.run_rounds(0, 3)
    tier = _tiered(cfg)
    got = _run(tier, 3)
    for a, b in zip(got, want):
        _same_round(a, b)
    assert_same_states(tier.store.host, dense.states)
    np.testing.assert_array_equal(tier.evaluate_final_streamed(),
                                  dense.evaluate())
    np.testing.assert_array_equal(tier.host.aggregation_count,
                                  dense.host.aggregation_count)


def test_partial_cohort_trains_as_the_dense_engine():
    cfg = _cfg(num_participants=0.5, num_rounds=1)
    tier, dense = _tiered(cfg), _dense(cfg)
    rt, rd = _run(tier, 1)[0], dense.run_round_fused(0)
    assert rt.selected == rd.selected and rt.aggregator == rd.aggregator
    sel = np.asarray(rt.selected)
    np.testing.assert_array_equal(rt.min_valid[sel], rd.min_valid[sel])
    np.testing.assert_array_equal(rt.tracking[sel], rd.tracking[sel])
    off = np.setdiff1d(np.arange(N), sel)
    assert np.isnan(rt.client_metrics[off]).all()
    assert np.isfinite(rt.client_metrics[sel]).all()
    assert [r["client_id"] for r in rt.verification_results] == \
        [i for i in sorted(rt.selected) if i != rt.aggregator]


@pytest.mark.parametrize("hooks", [
    {}, {"tie_break": True},
    {"chaos": ChaosSpec(dropout_p=0.3, crash_p=0.5, broadcast_loss_p=0.2)},
    {"elastic": ElasticSpec(leave_p=0.3, join_p=0.6)},
    {"cluster": ClusterSpec(k=2, refit_every=2)},
    {"cluster": ClusterSpec(k=2, refit_every=1),
     "elastic": ElasticSpec(leave_p=0.3, join_p=0.6)}, {"knn": True}])
def test_prefetched_loop_is_the_serial_loop(hooks):
    hooks = dict(hooks)
    cfg = _cfg(tie_break=hooks.pop("tie_break", False),
               num_participants=0.5, num_rounds=4,
               **(KNN if hooks.pop("knn", False) else {}))
    serial, pre = _tiered(cfg, **hooks), _tiered(cfg, **hooks)
    want = [serial.run_round(r) for r in range(4)]
    got = _run(pre, 4)
    for a, b in zip(got, want):
        _same_round(a, b)
    assert_same_states(pre.store.host, serial.store.host)
    s = pre.stats.summary()
    assert s["rounds"] == 4 and s["overlapped"]
    assert len(s["prefetch_gap_s"]) == 4 and len(s["prefetch_issue_s"]) == 3
    # cohorts overlap across rounds: the patch was exercised
    assert any(set(a.selected) & set(b.selected)
               for a, b in zip(got, got[1:]))


def test_padding_the_client_axis_changes_nothing():
    cfg = _cfg(tie_break=True, num_rounds=3)
    a, b = _tiered(cfg), _tiered(cfg, data=pad_federated_data(_data(), N + 4))
    for x, y in zip(_run(a, 3), _run(b, 3)):
        _same_round(x, y)
    assert_same_states(a.store.host, b.store.host)


def test_early_stop_drops_the_prefetch_and_keeps_the_streams():
    cfg = _cfg(tie_break=True, num_rounds=4)
    eng = _tiered(cfg)
    seen = []
    eng.run_rounds(0, 4, lambda r, s: seen.append(r) or len(seen) == 2)
    assert len(seen) == 2 and eng.stats.rounds == 2
    ref = _tiered(cfg)
    _run(ref, 2)
    assert_same_states(eng.store.host, ref.store.host)
    # the prefetch drew round 2's plan; the resume point is before it
    assert eng.rngs.state_dict() != ref.rngs.state_dict()


def test_streamed_final_evaluation_is_the_dense_evaluation():
    cfg = _cfg(num_participants=0.34, num_rounds=1)
    tier = _tiered(cfg)
    assert tier.cohort == 2 and len(tier._chunks()) == 3
    dense = _dense(cfg, states=tier.store.host)
    np.testing.assert_allclose(tier.evaluate_final_streamed(),
                               dense.evaluate(), rtol=1e-6, atol=1e-7)


# --------------------------------------------- against the JAX engine ----

def _jax_pair(attack=None, chaos=None, elastic=None, horizon=3):
    """(JAX TieredRoundEngine, port tiered engine) from the JAX tier's
    init, tie-break off, the JAX masks and timeline fed to the port."""
    kw = {**BASE, "num_participants": 0.5, "num_rounds": horizon}
    jcfg = JaxConfig(**kw, state_layout="tiered",
                     compat=JaxCompat(vote_tie_break=False))
    tcfg = _cfg(**kw)
    jclients = jax_synthetic(**DATA)
    data = _data()
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
    jeng = JaxTiered(jax_make_model("hybrid", *DIMS, jcfg.shrink_lambda),
                     jcfg, jax_stack(jclients, dev_x, 12), n_real=N,
                     rngs=JaxRngs(run=0), model_type="hybrid",
                     update_type="mse_avg", **jkw)
    init = client_states_from_numpy(
        jax.tree.map(np.array, jeng.store.host), LAYOUT, device="cpu")
    if elastic is not None:
        tkw["elastic_masks"] = MembershipMasks(*(
            np.asarray(m) for m in jeng._elastic_np))
    teng = _tiered(tcfg, data=data, states=init, **tkw)
    if chaos is not None:
        jm = ChaosMasks(*(np.asarray(m) for m in jeng._chaos_np))
        teng._chaos_columns = lambda t, rows: ChaosMasks(
            available=jm.available[t][rows][None],
            straggler=jm.straggler[t][rows][None],
            crash=jm.crash[t][None], bcast_drop=jm.bcast_drop[t][rows][None])
    return jeng, teng


def _leaf_err(got, want):
    return max(float((got[:, sl] - want[:, sl]).abs().max()
                     / want[:, sl].abs().max().clamp_min(1e-30))
               for sl in LAYOUT.slices())


@pytest.mark.parametrize("hooks", [
    {}, dict(attack=dict(kind="scale", strength=50.0, start_round=1)),
    dict(chaos=dict(dropout_p=0.3, crash_p=0.5, broadcast_loss_p=0.2)),
    dict(elastic=dict(leave_p=0.3, join_p=0.6))])
def test_matches_the_jax_tiered_engine(hooks):
    jeng, teng = _jax_pair(**hooks)
    want = _run(jeng, 3)
    got = _run(teng, 3)
    for w, g in zip(want, got):
        assert g.selected == w.selected
        assert g.aggregator == w.aggregator
        assert g.crashed_aggregator == w.crashed_aggregator
        assert g.effective == w.effective
        assert g.members == w.members
        assert g.verification_results == w.verification_results
        np.testing.assert_array_equal(np.isnan(g.client_metrics),
                                      np.isnan(w.client_metrics))
        np.testing.assert_allclose(g.client_metrics, w.client_metrics,
                                   rtol=0, atol=1e-5)
    host = jeng.store.host
    for name in ("params", "prev_global", "hist_params"):
        assert _leaf_err(getattr(teng.store.host, name),
                         LAYOUT.flatten(jax.tree.map(
                             lambda t: torch.from_numpy(np.array(t)),
                             getattr(host, name)))) <= 1e-5, name
    np.testing.assert_array_equal(teng.store.host.rejected.numpy(),
                                  np.asarray(host.rejected))
    np.testing.assert_array_equal(teng.host.aggregation_count,
                                  jeng.host.aggregation_count)
    np.testing.assert_allclose(teng.evaluate_final_streamed(),
                               jeng.evaluate_final_streamed(), atol=1e-5)


@pytest.mark.parametrize("clustered", [False, True])
def test_membership_transitions_match_jax(clustered):
    tier = TieredClientStore.create(_model(), 7,
                                    torch.Generator().manual_seed(3))
    for t in tier.host.opt_state:
        t += 1
    tier.host.hist_seen[:] = True
    tier.host.rejected[:] = 2
    tier.host.waived[:] = 0.5
    tier.host.hist_params += 0.25
    jhost = client_states_to_numpy(tier.host, LAYOUT)
    jtier = types.SimpleNamespace(host=jax.tree.map(np.array, jhost))
    member = np.array([1, 1, 1, 1, 0, 1, 1], np.float32)
    joined = np.array([0, 0, 0, 1, 0, 0, 1], np.float32)
    left = np.array([0, 1, 0, 0, 0, 0, 0], np.float32)
    kw = (dict(assignment=np.array([0, 1, 0, 1, 1, 0, 2]), k=3)
          if clustered else {})
    apply_membership_transitions(tier, member, joined, left, **kw)
    jax_transitions(jtier, member, joined, left, **kw)
    got = client_states_to_numpy(tier.host, LAYOUT)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtier.host)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-6,
                                   atol=1e-7)
    assert (tier.host.opt_state.mu[[1, 3, 6]] == 0).all()
    assert (tier.host.opt_state.mu[0] == 1).all()
    assert not tier.host.hist_seen[3] and tier.host.rejected[3] == 0
    assert tier.host.waived[3] == 0.5  # kept, as in the JAX tier
    # merge_partials, the host-sharded tier's cross-rank sum: two shards of
    # the same fleet, their partials summed, take the whole tier's rows
    base = TieredClientStore.create(_model(), 7,
                                    torch.Generator().manual_seed(3))
    shards = [TieredShardStore.from_dense_slice(base.host, 7, lo, hi)
              for lo, hi in ((0, 3), (3, 7))]
    parts = []
    for sh in shards:  # collect each shard's partial (on copies)
        scratch = TieredShardStore(sh.host.clone(), 7, sh.start, sh.stop)
        apply_membership_transitions(
            scratch, member, joined, left, **kw,
            merge_partials=lambda p: parts.append(p[0]) or p)
    for sh in shards:
        apply_membership_transitions(
            sh, member, joined, left, **kw,
            merge_partials=lambda p: [parts[0] + parts[1]])
    for sh in shards:
        np.testing.assert_allclose(
            sh.host.params.numpy(),
            tier.host.params.numpy()[sh.start:sh.stop], rtol=1e-6,
            atol=1e-7)


# ---------------------------------------------- faults, roster, layout ----

def test_chaos_columns_are_the_masks_columns():
    spec = ChaosSpec(dropout_p=0.4, straggler_p=0.3, crash_p=0.5,
                     broadcast_loss_p=0.2, start_round=1)
    key = ExperimentRngs(run=0).chaos_key()
    full = make_chaos_masks(spec, key, 0, 4, 9)
    draws = reelection_draws(key, 0, 4, 3, 9)
    ids = np.array([0, 2, 3, 7])
    for t in range(4):
        cols = chaos_columns(spec, key, t, ids)
        for name in ("available", "straggler", "bcast_drop"):
            np.testing.assert_array_equal(getattr(cols, name)[0],
                                          getattr(full, name)[t][ids])
        assert cols.crash[0] == full.crash[t]
        np.testing.assert_array_equal(reelection_columns(key, t, 3, ids),
                                      draws[t][:, ids])


def test_chaos_at_cohort_width():
    cfg = _cfg(tie_break=True, num_rounds=3)
    eng = _tiered(cfg, chaos=ChaosSpec(dropout_p=0.3, crash_p=0.5))
    for r in _run(eng, 3):
        assert r.divergence is not None and r.divergence.shape == (N,)
        assert set(r.effective) <= set(r.selected)
        off = np.setdiff1d(np.arange(N), r.selected)
        assert (r.divergence[off] == 0).all()  # the JAX tier's fill


def test_elastic_roster():
    cfg = _cfg(num_rounds=3)
    eng = _tiered(cfg, elastic=ElasticSpec(leave_p=0.3, join_p=0.5))
    res = _run(eng, 3)
    assert res[-1].members is not None and res[-1].generations is not None
    member = eng.members_at(3)
    assert sorted(res[-1].members) == np.flatnonzero(member).tolist()
    np.testing.assert_array_equal(res[-1].generations, eng.generation_at(3))
    assert eng.evaluate_final_streamed().shape == (N,)
    assert eng.stats.summary()["rounds"] == 3


def test_checkpoints_interchange_between_layouts(tmp_path):
    cfg = _cfg(num_rounds=2)
    tier = _tiered(cfg)
    _run(tier, 2)
    ck = CheckpointManager(str(tmp_path))
    ck.save("tag", tier.states_for_checkpoint(N + 2), tier.host, 2,
            layout=LAYOUT)
    dense = _dense(cfg, data=pad_federated_data(_data(), N + 2))
    st, host, ri, _ = ck.restore("tag", layout=LAYOUT, device="cpu")
    assert ri == 2 and st.params.shape[0] == N + 2
    assert_same_states(st.apply(lambda t: t[:N]), tier.store.host)
    np.testing.assert_array_equal(host.aggregation_count,
                                  tier.host.aggregation_count)
    ck.save("dense_tag", dense.states, dense.host, 1, layout=LAYOUT)
    st2, _, _, _ = ck.restore("dense_tag", layout=LAYOUT, device="cpu")
    fresh = _tiered(cfg)
    fresh.restore_states(st2)
    assert_same_states(fresh.store.host,
                       dense.states.apply(lambda t: t[:N]))


def test_resumed_tiered_run_is_the_uninterrupted_run(tmp_path):
    from fedmse_tpu_torch.main import run_combination
    cfg = _cfg(tie_break=True, num_rounds=3, state_layout="tiered")
    data = _data()
    whole = run_combination(cfg, data, N, "hybrid", "mse_avg", 0)
    ck = CheckpointManager(str(tmp_path))
    run_combination(cfg.replace(num_rounds=2), data, N, "hybrid",
                    "mse_avg", 0, resume=ck)
    resumed = run_combination(cfg, data, N, "hybrid", "mse_avg", 0,
                              resume=ck)
    assert resumed["rounds_run"] == 1
    _same_round(resumed["rounds"][0], whole["rounds"][2])
    assert_same_states(resumed["engine"].store.host,
                       whole["engine"].store.host)


def test_redteam_null_builds_nothing_and_an_active_spec_raises():
    cfg = _cfg(num_rounds=2)
    plain, null = _tiered(cfg), _tiered(cfg, redteam=RedteamSpec())
    for a, b in zip(_run(plain, 2), _run(null, 2)):
        _same_round(a, b)
    assert null._round.input_names == plain._round.input_names
    with pytest.raises(ValueError, match="null RedteamSpec"):
        _tiered(cfg, redteam=RedteamSpec(min_tenure=1))


def test_guards_name_what_waits():
    cfg = _cfg()
    with pytest.raises(ValueError, match="ClientMesh"):
        _tiered(cfg, mesh=object())
    with pytest.raises(ValueError, match="need a client mesh"):
        _tiered(cfg, host_sharded=True)
    with pytest.raises(ValueError, match="time"):
        _tiered(cfg.replace(metric="time"))
    with pytest.raises(ValueError, match="aggregation_backend"):
        _tiered(cfg.replace(aggregation_backend="psum"))
    with pytest.raises(ValueError, match="TieredRoundEngine"):
        _dense(cfg.replace(state_layout="tiered"))
    with pytest.raises(ValueError, match="dense-layout only"):
        BatchedRunEngine(_model(), cfg.replace(state_layout="tiered"),
                         _data(), n_real=N, runs=2, model_type="hybrid",
                         update_type="mse_avg")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TieredRoundEngine(_model(), cfg, _data(), N,
                              ExperimentRngs(run=0), "hybrid", "mse_avg")


def test_mesh_backends_degrade_to_einsum_with_one_warning(caplog):
    caplog.set_level(logging.WARNING)
    eng = _tiered(_cfg(aggregation_backend="quantized", num_rounds=1))
    assert eng.agg_backend == "einsum"
    _run(eng, 1)
    msgs = [r.getMessage() for r in caplog.records if "inert" in
            r.getMessage()]
    assert len(msgs) == 1 and "not sharded" in msgs[0]
    assert TieredStats().summary()["overlapped"] is False


# ------------------------------------------------------------- the CLI ----

@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("tiered_shards")
    for k in range(1, 5):
        for split, n, s in (("normal", 80, 0.0), ("abnormal", 30, 4.0),
                            ("test_normal", 15, 0.0)):
            d = root / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(s, 1.0, (n, 12)),
                       delimiter=",")
    path = root / "config.json"
    path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(root), 4).to_json()))
    return str(path)


def _cli(dataset_json, root, *flags):
    return main(["--dataset-config", dataset_json, "--device", "cpu",
                 "--model-types", "hybrid", "--update-types", "mse_avg",
                 "--network-size", "4", "--dim-features", "12",
                 "--epochs", "2", "--batch-size", "8", "--num-rounds", "3",
                 "--checkpoint-dir", str(root), *flags])


def test_cli_tiered_writes_the_dense_artifacts(dataset_json, tmp_path):
    dense = _cli(dataset_json, tmp_path / "dense", "--num-participants",
                 "1.0")
    tiered = _cli(dataset_json, tmp_path / "tiered", "--num-participants",
                  "1.0", "--state-layout", "tiered")
    assert dense["best_metrics"] == tiered["best_metrics"]
    files = {}
    for tag in ("dense", "tiered"):
        root = tmp_path / tag
        files[tag] = sorted(
            os.path.relpath(f, root) for f in glob.glob(
                str(root / "**" / "*.*"), recursive=True))
    assert files["dense"] == files["tiered"] and files["dense"]
    for rel in files["dense"]:
        if rel.endswith("training_summary.json"):
            continue  # holds the rounds' wall-clock seconds
        with open(tmp_path / "dense" / rel, "rb") as a, \
                open(tmp_path / "tiered" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    partial = _cli(dataset_json, tmp_path / "partial", "--state-layout",
                   "tiered", "--no-save")
    assert len(partial["results"]["hybrid/mse_avg/run0"][
        "final_metrics"]) == 4
    # a host-sharded tier of one rank is the plain tier, bit for bit
    sharded = _cli(dataset_json, tmp_path / "x", "--state-layout", "tiered",
                   "--no-save", "--host-sharded", "true")
    assert sharded["results"]["hybrid/mse_avg/run0"]["final_metrics"] == \
        partial["results"]["hybrid/mse_avg/run0"]["final_metrics"]
    with pytest.raises(ValueError, match="state-layout tiered"):
        _cli(dataset_json, tmp_path / "z", "--host-sharded", "true")
    with pytest.raises(ValueError, match="state_layout"):
        _cli(dataset_json, tmp_path / "y", "--state-layout", "sparse")


def test_cli_batch_runs_with_tiered_runs_sequentially(dataset_json, tmp_path,
                                                      caplog):
    caplog.set_level(logging.WARNING)
    out = _cli(dataset_json, tmp_path, "--state-layout", "tiered",
               "--num-runs", "2", "--batch-runs", "--no-save")
    msgs = [r.getMessage() for r in caplog.records
            if "--batch-runs disabled" in r.getMessage()]
    assert len(msgs) == 1 and "state_layout=tiered" in msgs[0]
    assert set(out["results"]) == {"hybrid/mse_avg/run0",
                                   "hybrid/mse_avg/run1"}
