"""The port's elastic membership (fedmse_tpu_torch/federation/elastic.py and
the elastic hook of federation/fused.py) against the JAX package's, case
by case with tests/test_elastic.py (the batched-runs and the serving
roster-swap cases excepted: neither is ported):

  * the spec's validation, with the JAX package's messages, and its
    checkpoint signature, spelled as JAX spells it; elastic needs the
    fused round;
  * the port's own timeline: reproducible, a prefix of any longer
    horizon, the slot pool's chain invariants, per-event windows,
    padding-invariant and domain-separated;
  * a null spec is bit-identical to the clean fused round;
  * a leave retires a slot (no aggregate once everyone left, moments
    zeroed, metrics NaN); a join inherits the incumbent mean with zeroed
    moments and cleared history; a leave alone zeroes the moments only;
  * JAX-fed rounds (the JAX engine's timeline through `elastic_masks=`,
    with chaos and an attack composed in) match the JAX fused engine;
  * 3 chunks of 2 == 6 single rounds, bit for bit, on one FusedRound;
  * the membership metrics and the joiner gap equal JAX's;
  * the CLI: the tagged experiment tree, the summary's spec, and a bad
    rate refused by name.
"""

import glob
import json
import types

import numpy as np
import pytest
import torch

from fedmse_tpu.chaos import joiner_incumbent_gap as jax_gap
from fedmse_tpu.chaos import membership_metrics as jax_membership
from fedmse_tpu.federation import ElasticSpec as JaxSpec
from fedmse_tpu_torch.chaos import (ChaosSpec, joiner_incumbent_gap,
                                    membership_metrics)
from fedmse_tpu_torch.config import DatasetConfig
from fedmse_tpu_torch.federation.elastic import (ElasticSpec,
                                                 MembershipMasks,
                                                 all_member_masks,
                                                 make_membership_masks,
                                                 membership_at)
from fedmse_tpu_torch.federation.state import tree_select_clients
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import (N, assert_matches_jax,
                                      assert_same_round, assert_same_states,
                                      pair, port_engine)

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    *({field: v} for field in ("leave_p", "join_p", "preempt_p")
      for v in (1.5, -0.1)),
    dict(initial_member_frac=0.0),
    dict(leave_p=0.5, start_round=3, stop_round=3),
    dict(leave_p=0.5, leave_window=(4, 4)),
    dict(join_p=0.5, join_window=(-1, 3)), dict(start_round=-2),
    dict(preempt_window=(1, 2, 3))])
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        ElasticSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, dict(join_p=0.1), dict(initial_member_frac=0.5),
    dict(leave_p=0.3, join_p=0.6, leave_window=(4, 6)),
    dict(leave_p=0.3, join_p=0.6, preempt_p=0.05, start_round=1,
         stop_round=9, join_window=(2, None))])
def test_signature_and_null_match_jax(kw):
    assert ElasticSpec(**kw).signature() == JaxSpec(**kw).signature()
    assert ElasticSpec(**kw).is_null == JaxSpec(**kw).is_null
    assert ElasticSpec(**kw).window_for("join") == \
        JaxSpec(**kw).window_for("join")


def test_elastic_requires_fused_engine():
    for kw in (dict(fused=False), dict(fused=True, profile=True)):
        with pytest.raises(ValueError, match="fused"):
            port_engine(elastic=ElasticSpec(leave_p=0.5), **kw)
    with pytest.raises(ValueError, match="ElasticSpec"):
        port_engine(elastic_masks=all_member_masks(N))


def test_masks_reproduce_and_obey_chain_invariants():
    spec = ElasticSpec(leave_p=0.4, join_p=0.5, preempt_p=0.2)
    key = ExperimentRngs(run=0).elastic_key()
    a = make_membership_masks(spec, key, 10, N)
    for la, lb in zip(a, make_membership_masks(spec, key, 10, N)):
        np.testing.assert_array_equal(la, lb)
    for la, lc in zip(a, make_membership_masks(spec, key, 16, N)):
        np.testing.assert_array_equal(la, lc[:10])
    prev_m, prev_g = np.ones(N), np.zeros(N, int)
    for t in range(10):
        member, joined, left, gen = (x[t] for x in a)
        assert (member[joined > 0] == 1).all()
        assert (member[left > 0] == 0).all()
        np.testing.assert_array_equal(gen - prev_g, (joined > 0).astype(int))
        assert (prev_m[left > 0] == 1).all()
        new_joins = (joined > 0) & (prev_m == 0)
        np.testing.assert_array_equal(
            member, ((prev_m > 0) & (left == 0)) | new_joins)
        prev_m, prev_g = member, gen
    assert (a.left.sum() > 0) and (a.joined.sum() > 0)
    other = make_membership_masks(spec, ExperimentRngs(run=1).elastic_key(),
                                  10, N)
    assert any(not np.array_equal(x, y) for x, y in zip(a, other))
    null = make_membership_masks(ElasticSpec(), key, 1, N)
    for x, y in zip(null, all_member_masks(N)):
        np.testing.assert_array_equal(x, y)


def test_masks_respect_per_event_windows():
    spec = ElasticSpec(leave_p=1.0, join_p=1.0, leave_window=(2, 4),
                       join_window=(4, None))
    m = make_membership_masks(spec, ExperimentRngs(run=0).elastic_key(),
                              8, N)
    assert (m.member[:2] == 1).all() and (m.member[2:4] == 0).all()
    assert (m.member[4:] == 1).all()
    assert m.left[2].sum() == N and m.left[3].sum() == 0


def test_masks_are_padding_invariant():
    spec = ElasticSpec(leave_p=0.4, join_p=0.5, preempt_p=0.2,
                       initial_member_frac=0.7)
    key = ExperimentRngs(run=0).elastic_key()
    narrow = make_membership_masks(spec, key, 10, N)
    for pad in (N + 1, 2 * N, 16):
        wide = make_membership_masks(spec, key, 10, pad)
        for ln, lw in zip(narrow, wide):
            np.testing.assert_array_equal(ln, lw[:, :N])


def test_elastic_key_is_domain_separated():
    rngs = ExperimentRngs(run=0)
    gen, sel = rngs.generator.get_state(), rngs.select_rng.getstate()
    spec = ElasticSpec(leave_p=0.5, join_p=0.5)
    a = make_membership_masks(spec, rngs.elastic_key(), 6, N)
    assert torch.equal(rngs.generator.get_state(), gen)
    assert rngs.select_rng.getstate() == sel
    b = make_membership_masks(spec, rngs.chaos_key(), 6, N)
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_null_elastic_bit_identical_schedule():
    base, null = port_engine(), port_engine(elastic=ElasticSpec())
    for rb, rz in zip(base.run_rounds(0, 3), null.run_rounds(0, 3)):
        assert rb.members is None and rb.generations is None
        assert rz.members == list(range(N)) and not rz.generations.any()
        assert_same_round(rz, rb, observables=False)
    assert_same_states(base.states, null.states)


def test_leave_retires_slots():
    eng = port_engine(elastic=ElasticSpec(leave_p=1.0, leave_window=(1, 2)))
    results = eng.run_rounds(0, 3)
    assert results[0].members == list(range(N))
    assert results[0].aggregator is not None
    for r in results[1:]:
        assert r.members == [] and r.aggregator is None
        assert r.effective == [] and np.isnan(r.client_metrics).all()
    for t in eng.states.opt_state:
        assert not t.any()
    mets = membership_metrics(results)
    assert mets["leaves"] == N and mets["joins"] == 0
    assert mets["final_members"] == 0
    assert not eng.members_at(3).any()
    np.testing.assert_array_equal(eng.generation_at(3), np.zeros(N))


def _one_round(masks_round0, states):
    """A single-voter round (no candidate: no merge) from `states` under a
    crafted membership round."""
    timeline = MembershipMasks(*(np.asarray(m)[None] for m in masks_round0))
    eng = port_engine(states=states, elastic=ElasticSpec(leave_p=0.1),
                      elastic_masks=timeline)
    res = eng.run_round_fused(0, selected=[0])
    assert res.aggregator is None
    return eng, res


def test_join_inherits_global_and_zeroes_moments():
    j = 2
    st = port_engine().states.clone()
    st.params[j] = 99.0
    for t in st.opt_state:
        t[j] = 1
    st.hist_params[j], st.hist_perf[j], st.hist_seen[j] = 3.0, 5.0, True
    st.rejected[j], st.waived[j] = 7, 9.0
    others = [i for i in range(N) if i != j]
    incumbent_mean = st.params[others].mean(dim=0)
    before = st.clone()
    onehot = (np.arange(N) == j).astype(np.float32)
    eng, _ = _one_round((np.ones(N, np.float32), onehot,
                         np.zeros(N, np.float32), onehot.astype(np.int32)),
                        st)
    new = eng.states
    torch.testing.assert_close(new.params[j], incumbent_mean, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(new.prev_global[j], incumbent_mean,
                               rtol=1e-5, atol=1e-7)
    for t in new.opt_state:
        assert not t[j].any()
    assert not new.hist_params[j].any() and new.hist_perf[j] == 0
    assert not new.hist_seen[j] and new.rejected[j] == 0
    assert new.waived[j] == 0
    assert torch.equal(new.params[3], before.params[3])


def test_leave_zeroes_moments_only():
    leaver = 1
    st = port_engine().states.clone()
    for t in st.opt_state:
        t.fill_(1)
    before = st.clone()
    eng, res = _one_round(((np.arange(N) != leaver).astype(np.float32),
                           np.zeros(N, np.float32),
                           (np.arange(N) == leaver).astype(np.float32),
                           np.zeros(N, np.int32)), st)
    for t in eng.states.opt_state:
        assert not t[leaver].any() and (t[3] == 1).all()
    assert torch.equal(eng.states.params[leaver], before.params[leaver])
    assert np.isnan(res.client_metrics[leaver])
    assert res.members == [i for i in range(N) if i != leaver]


SPECS = [dict(leave_p=0.3, join_p=0.5, preempt_p=0.2),
         dict(leave_p=0.5, join_p=0.5, initial_member_frac=0.5)]


@pytest.mark.parametrize("spec", SPECS)
def test_jax_fed_elastic_rounds_match_jax(spec):
    jeng, teng = pair(elastic=spec, num_participants=0.75)
    jres, tres = jeng.run_rounds(0, 4), teng.run_rounds(0, 4)
    assert any(r.members != list(range(N)) for r in tres)
    assert any(r.generations.any() for r in tres)
    assert_matches_jax(jres, tres, jeng, teng)


def test_jax_fed_fault_path_matches_jax():
    """Elastic, chaos and a scale attack composed, the whole fault path,
    against the JAX fused engine."""
    jeng, teng = pair(elastic=SPECS[0],
                      chaos=dict(dropout_p=0.2, straggler_p=0.1,
                                 crash_p=0.5, broadcast_loss_p=0.1),
                      attack=dict(kind="scale", strength=5.0, start_round=1),
                      num_participants=1.0)
    jres, tres = jeng.run_rounds(0, 4), teng.run_rounds(0, 4)
    assert any(r.aggregator is not None for r in tres)
    assert_matches_jax(jres, tres, jeng, teng)


def test_elastic_chunking_invariant():
    spec = ElasticSpec(leave_p=0.3, join_p=0.5, preempt_p=0.1)
    chaos = ChaosSpec(dropout_p=0.2, crash_p=0.3)
    a = port_engine(elastic=spec, chaos=chaos)
    res_a = a.run_rounds(0, 2) + a.run_rounds(2, 2) + a.run_rounds(4, 2)
    b = port_engine(elastic=spec, chaos=chaos)
    res_b = [b.run_round_fused(i) for i in range(6)]
    assert any(r.members != list(range(N)) for r in res_a)
    for ra, rb in zip(res_a, res_b):
        assert_same_round(ra, rb)
    assert_same_states(a.states, b.states)
    f = a.fused_round()
    a.run_rounds(6, 2)  # a longer horizon regrows the timeline, not the round
    assert a.fused_round() is f
    masks = make_membership_masks(spec, a.rngs.elastic_key(), 8, N)
    member, gen = membership_at(masks, 8, N)
    np.testing.assert_array_equal(a.members_at(8), member)
    np.testing.assert_array_equal(a.generation_at(8), gen)


def _fake(t, members, generations):
    return types.SimpleNamespace(round_index=t, members=members,
                                 generations=np.asarray(generations))


def test_membership_metrics_match_jax():
    results = [_fake(0, [0, 1, 2], [0, 0, 0]), _fake(1, [0, 2], [0, 0, 0]),
               _fake(2, [0, 2], [1, 0, 0]), _fake(3, [0, 1, 2], [1, 1, 0])]
    mets = membership_metrics(results)
    assert mets == jax_membership(results)
    assert mets["joins"] == 2 and mets["leaves"] == 1
    assert sorted(mets["staleness_at_rejoin"]) == [0, 2]
    partial = [_fake(0, [0, 2], [0, 0, 0]), _fake(2, [0, 1, 2], [0, 1, 0])]
    init = np.asarray([True, False, True])
    assert membership_metrics(partial, initial_members=init) == \
        jax_membership(partial, initial_members=init)
    static = [types.SimpleNamespace(round_index=0, members=None,
                                    generations=None)]
    assert membership_metrics(static) == {"elastic": False}
    eng = port_engine(elastic=ElasticSpec(**SPECS[0]))
    real = eng.run_rounds(0, 5)
    assert membership_metrics(real) == jax_membership(real)
    final = np.asarray([0.9, 0.8, 0.95, np.nan])
    gen = np.asarray([0, 1, 2, 0])
    base = np.asarray([0.92, 0.81, 0.94, 0.9])
    assert joiner_incumbent_gap(final, gen, baseline_metrics=base) == \
        jax_gap(final, gen, baseline_metrics=base)


def test_tree_select_clients():
    a, b = torch.ones(3, 2), torch.zeros(3, 2)
    keep = torch.tensor([True, False, True])
    assert torch.equal(tree_select_clients(keep, a, b)[:, 0],
                       keep.to(torch.float32))


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("elastic_shards")
    for k in range(1, N + 1):
        for split, n, shift in (("normal", 80, 0.0), ("abnormal", 30, 4.0),
                                ("test_normal", 15, 0.0)):
            d = root / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(shift, 1.0, (n, 12)),
                       delimiter=",")
    path = root / "config.json"
    path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(root), N).to_json()))
    return str(path)


def _cli(cfg_path, tmp_path, sub, extra):
    from fedmse_tpu_torch.main import main
    return main(["--dataset-config", cfg_path, "--device", "cpu",
                 "--model-types", "hybrid", "--update-types", "avg",
                 "--network-size", str(N), "--dim-features", "12",
                 "--epochs", "1", "--batch-size", "8", "--no-save",
                 "--global-patience", "99", "--fused-schedule-chunk", "2",
                 "--checkpoint-dir", str(tmp_path / ("c" + sub)),
                 "--experiment-name", "el" + sub] + extra)


def test_cli_elastic_end_to_end(dataset_json, tmp_path):
    out = _cli(dataset_json, tmp_path, "2",
               ["--elastic-leave", "0.3", "--elastic-join", "0.5",
                "--chaos-crash", "0.5", "--attack-kind", "sign_flip",
                "--num-rounds", "3"])
    assert out["elastic"]["join_p"] == 0.5
    assert out["chaos"]["crash_p"] == 0.5
    assert out["attack"] == {"kind": "sign_flip", "strength": 10.0,
                             "every_k": 1, "start_round": 1,
                             "stop_round": None}
    tree = ("el2_attack-sign_flip-10-k1s1_chaos-d0g0c0.5b0s0"
            "_elastic-l0.3j0.5p0s0")
    assert glob.glob(str(tmp_path / "c2" / "Results" / "Update" / str(N) /
                         tree / "**" / "*.json"), recursive=True)
    with pytest.raises(ValueError, match="leave_p"):
        _cli(dataset_json, tmp_path, "3",
             ["--elastic-leave", "-0.5", "--num-rounds", "2"])
    with pytest.raises(ValueError, match="dropout_p"):
        _cli(dataset_json, tmp_path, "3",
             ["--chaos-dropout", "-0.5", "--num-rounds", "2"])
