"""The port's fault injection (fedmse_tpu_torch/chaos/ and the chaos hook of
federation/fused.py) against the JAX package's, case by case with
tests/test_chaos.py (the batched-runs case excepted: batched runs are not
ported):

  * the spec's validation, with the JAX package's messages; chaos needs
    the fused round;
  * the port's own masks: reproducible, windowed, chunking- and
    padding-invariant, and domain-separated (drawing them consumes
    nothing, and a chaotic run selects and initializes as a clean one);
  * a zero-probability spec is bit-identical to the clean fused round;
  * full dropout takes no aggregate path; a crash re-elects a
    quota-eligible survivor, and a crash with no survivor takes no
    aggregate; broadcast loss keeps the local state; a dropped client
    misses the broadcast;
  * JAX-fed rounds (the JAX engine's masks fed to the port) match the JAX
    fused engine: aggregators, crashed aggregators, effective cohorts and
    verification rows equal, states and divergence within 1e-5;
  * a chunk of 3 == 3 single rounds and 3 chunks of 2 == 6 single rounds,
    bit for bit (with the tie-break too: the re-election's draws);
  * the resilience metrics equal JAX's on the same results.
"""

import numpy as np
import pytest
import torch

from fedmse_tpu.chaos import ChaosSpec as JaxSpec
from fedmse_tpu.chaos import resilience_metrics as jax_resilience
from fedmse_tpu.chaos import rounds_to_recover as jax_recover
from fedmse_tpu_torch.chaos import (ChaosSpec, all_clear_masks,
                                    make_chaos_masks, reelection_draws,
                                    resilience_metrics, rounds_to_recover)
from fedmse_tpu_torch.chaos.metrics import quota_exhaustion_round
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import (N, assert_matches_jax,
                                      assert_same_round, assert_same_states,
                                      pair, port_cfg, port_engine)

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    *({field: v} for field in ("dropout_p", "straggler_p", "crash_p",
                               "broadcast_loss_p") for v in (1.5, -0.1)),
    dict(dropout_p=0.5, start_round=3, stop_round=3),
    dict(start_round=-1)])
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        ChaosSpec(**kw)
    assert str(got.value) == str(want.value)


def test_spec_null_and_fused_only():
    assert ChaosSpec().is_null and not ChaosSpec(crash_p=0.1).is_null
    for kw in (dict(fused=False), dict(fused=True, profile=True)):
        with pytest.raises(ValueError, match="fused"):
            port_engine(chaos=ChaosSpec(dropout_p=0.5), **kw)
    eng = port_engine(chaos=ChaosSpec(dropout_p=0.5))
    eng.profile = True  # the per-phase path refuses chaos at run time too
    with pytest.raises(ValueError, match="fused round only"):
        eng.run_round(0)


def test_masks_reproduce_from_seed_and_respect_window():
    spec = ChaosSpec(dropout_p=0.5, straggler_p=0.3, crash_p=0.5,
                     broadcast_loss_p=0.4, start_round=2, stop_round=5)
    key = ExperimentRngs(run=0).chaos_key()
    a = make_chaos_masks(spec, key, 0, 8, N)
    for la, lb in zip(a, make_chaos_masks(spec, key, 0, 8, N)):
        np.testing.assert_array_equal(la, lb)
    for la, lc in zip(a, make_chaos_masks(spec, key, 3, 3, N)):
        np.testing.assert_array_equal(la[3:6], lc)
    avail, strag, crash, drop = a
    clear = [0, 1, 5, 6, 7]
    assert (avail[clear] == 1).all() and (strag[clear] == 0).all()
    assert (drop[clear] == 0).all() and not crash[clear].any()
    assert (avail[2:5] == 0).any() and crash[2:5].any()
    other = make_chaos_masks(spec, ExperimentRngs(run=1).chaos_key(), 0, 8, N)
    assert any(not np.array_equal(x, y) for x, y in zip(a, other))
    null = make_chaos_masks(ChaosSpec(), key, 0, 1, N)
    for x, y in zip(null, all_clear_masks(N)):
        np.testing.assert_array_equal(x, y)


def test_masks_are_padding_invariant():
    spec = ChaosSpec(dropout_p=0.4, straggler_p=0.3, crash_p=0.3,
                     broadcast_loss_p=0.2)
    key = ExperimentRngs(run=0).chaos_key()
    small = make_chaos_masks(spec, key, 0, 6, N)
    padded = make_chaos_masks(spec, key, 0, 6, N + 5)
    for name in ("available", "straggler", "bcast_drop"):
        np.testing.assert_array_equal(getattr(small, name),
                                      getattr(padded, name)[:, :N])
    np.testing.assert_array_equal(small.crash, padded.crash)
    np.testing.assert_array_equal(reelection_draws(key, 2, 3, 2, N),
                                  reelection_draws(key, 0, 5, 2, N + 3)
                                  [2:, :, :N])


def test_chaos_key_is_domain_separated():
    """Drawing masks consumes nothing from the run's streams, the chaos
    stream is not the elastic or attack stream, and a chaotic engine
    starts from the clean engine's init and selections."""
    rngs = ExperimentRngs(run=0)
    gen, sel = rngs.generator.get_state(), rngs.select_rng.getstate()
    spec = ChaosSpec(dropout_p=0.5, straggler_p=0.5, broadcast_loss_p=0.5)
    a = make_chaos_masks(spec, rngs.chaos_key(), 0, 4, N)
    assert torch.equal(rngs.generator.get_state(), gen)
    assert rngs.select_rng.getstate() == sel
    for other in (rngs.elastic_key(), rngs.attack_key()):
        b = make_chaos_masks(spec, other, 0, 4, N)
        assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    clean, chaotic = port_engine(), port_engine(chaos=spec)
    assert torch.equal(clean.states.params, chaotic.states.params)
    assert [clean.select_clients() for _ in range(4)] == \
        [chaotic.select_clients() for _ in range(4)]


def test_zero_chaos_bit_identical_schedule():
    base, zero = port_engine(), port_engine(chaos=ChaosSpec())
    for rb, rz in zip(base.run_rounds(0, 3), zero.run_rounds(0, 3)):
        assert rz.effective == rz.selected and rz.crashed_aggregator is None
        assert rb.divergence is None and rz.divergence is not None
        assert_same_round(rz, rb, observables=False)
    assert_same_states(base.states, zero.states)
    np.testing.assert_array_equal(base.host.aggregation_count,
                                  zero.host.aggregation_count)


def test_full_dropout_takes_no_aggregate_path():
    eng = port_engine(chaos=ChaosSpec(dropout_p=1.0))
    p0 = eng.states.params.clone()
    results = eng.run_rounds(0, 2)
    assert all(r.aggregator is None and r.effective == [] for r in results)
    assert torch.equal(eng.states.params, p0)
    assert all(np.isnan(r.min_valid).all() for r in results)
    mets = resilience_metrics(results)
    assert mets["effective_participation"] == 0.0
    assert mets["no_aggregator_rounds"] == 2
    assert mets["quota_exhaustion_round"] == 0


def test_aggregator_crash_reelects_quota_eligible_survivor():
    eng = port_engine(cfg=port_cfg(num_participants=1.0),
                      chaos=ChaosSpec(crash_p=1.0))
    results = eng.run_rounds(0, 3)
    for r in results:
        assert r.crashed_aggregator is not None and r.aggregator is not None
        assert r.aggregator != r.crashed_aggregator
        assert r.aggregator in r.selected
        assert r.agg_weights[r.crashed_aggregator] == 0
    crashed_only = {r.crashed_aggregator for r in results} - \
        {r.aggregator for r in results}
    for c in crashed_only:
        assert eng.host.aggregation_count[c] == 0
    assert resilience_metrics(results)["re_elections"] == 3


def test_crash_with_no_survivor_falls_back_to_no_aggregate():
    eng = port_engine(chaos=ChaosSpec(crash_p=1.0))  # S = 2
    results = eng.run_rounds(0, 2)
    for r in results:
        assert r.crashed_aggregator is not None and r.aggregator is None
    mets = resilience_metrics(results)
    assert mets["crash_outages"] == 2 and mets["re_elections"] == 0


def test_broadcast_loss_keeps_local_state_across_merge():
    eng = port_engine(chaos=ChaosSpec(broadcast_loss_p=1.0))
    prev0 = eng.states.prev_global.clone()
    results = eng.run_rounds(0, 2)
    assert any(r.aggregator is not None for r in results)
    assert not eng.states.hist_seen.any()
    assert not eng.states.rejected.any()
    assert torch.equal(eng.states.prev_global, prev0)
    assert (results[-1].divergence >= 0).all()


def test_dropped_clients_miss_the_broadcast():
    spec = ChaosSpec(dropout_p=0.5)
    eng = port_engine(cfg=port_cfg(num_participants=1.0), chaos=spec)
    seen_down = False
    for r in range(4):
        before = eng.states.hist_seen.clone()
        res = eng.run_round_fused(r)
        after = eng.states.hist_seen
        down = make_chaos_masks(spec, eng.rngs.chaos_key(), r, 1,
                                N).available[0] <= 0
        if res.aggregator is None:
            assert torch.equal(after, before)
            continue
        assert torch.equal(after[down], before[down])
        up = ~down
        up[res.aggregator] = False
        assert after[up].all()
        seen_down |= bool(down.any())
    assert seen_down


SPECS = [dict(dropout_p=0.3, straggler_p=0.2, broadcast_loss_p=0.3),
         dict(crash_p=1.0), dict(crash_p=0.5, dropout_p=0.2),
         dict(straggler_p=0.5, crash_p=0.5, broadcast_loss_p=0.5)]


@pytest.mark.parametrize("spec", SPECS)
def test_jax_fed_chaos_rounds_match_jax(spec):
    jeng, teng = pair(chaos=spec, num_participants=0.75)
    jres, tres = jeng.run_rounds(0, 3), teng.run_rounds(0, 3)
    assert any(r.effective != r.selected or r.crashed_aggregator is not None
               for r in tres)
    assert_matches_jax(jres, tres, jeng, teng)


@pytest.mark.parametrize("tie_break", [False, True])
def test_chaos_chunking_invariant(tie_break):
    """3 chunks of 2 == 6 single rounds, and a chunk of 3 == 3 single
    rounds, bit for bit, with an attack composed in (the re-election's
    tie-break draws come from the chaos stream per absolute round)."""
    spec = ChaosSpec(dropout_p=0.3, crash_p=0.5, broadcast_loss_p=0.3)
    cfg = port_cfg(tie_break=tie_break, num_participants=0.75)

    def engine():
        return port_engine(cfg=cfg, chaos=spec, poison_fn=make_poison_fn(
            AttackSpec(kind="noise", strength=0.1, start_round=1)))
    a, b, c = engine(), engine(), engine()
    res_a = a.run_rounds(0, 2) + a.run_rounds(2, 2) + a.run_rounds(4, 2)
    res_b = [b.run_round_fused(i) for i in range(6)]
    res_c = c.run_rounds(0, 3) + c.run_rounds(3, 3)
    assert any(r.crashed_aggregator is not None for r in res_b)
    for ra, rb, rc in zip(res_a, res_b, res_c):
        assert_same_round(ra, rb)
        assert_same_round(rc, rb)
    assert_same_states(a.states, b.states)
    assert_same_states(c.states, b.states)


def test_fused_round_is_built_once_across_chunks():
    eng = port_engine(chaos=ChaosSpec(dropout_p=0.3, crash_p=0.5))
    eng.run_rounds(0, 2)
    f = eng.fused_round()
    eng.run_rounds(2, 2)
    assert eng.fused_round() is f and f.chaos and not f.elastic
    assert "available" in f.input_names and "noise" not in f.input_names


def test_resilience_metrics_match_jax():
    """The port's metrics and JAX's on the same port RoundResults (a
    chaotic schedule with a burst window)."""
    spec = ChaosSpec(dropout_p=0.3, crash_p=0.5, broadcast_loss_p=0.3,
                     start_round=1, stop_round=3)
    eng = port_engine(cfg=port_cfg(num_participants=0.75), chaos=spec)
    results = eng.run_rounds(0, 5)
    for kw in ({}, dict(burst_start=1, burst_stop=3, recover_eps=0.05)):
        assert resilience_metrics(results, **kw) == \
            jax_resilience(results, **kw)
    assert quota_exhaustion_round(results) == \
        jax_resilience(results)["quota_exhaustion_round"]


def test_rounds_to_recover():
    curve = [0.9, 0.5, 0.4, 0.6, 0.91, 0.92]
    for args, want in (((1, 3, 0.01), 1), ((1, 3, 0.5), 0), ((0, 3), None)):
        assert rounds_to_recover(curve, *args) == want
        assert jax_recover(curve, *args) == want
    assert rounds_to_recover([0.9, 0.1, 0.1, 0.1], 1, 2) is None


def test_fault_caches_follow_the_run():
    """A reset keeps the run, so the horizon's masks stay cached; an engine
    handed another run's streams redraws them, and a reset engine replays
    its rounds bit for bit."""
    eng = port_engine(chaos=ChaosSpec(dropout_p=0.5, crash_p=0.5),
                      cfg=port_cfg(tie_break=True))
    first = eng.run_rounds(0, 2)
    held = eng._chaos_premade
    eng.reset_federation()
    assert eng._chaos_premade is held
    for got, want in zip(eng.run_rounds(0, 2), first):
        assert_same_round(got, want)
    eng.rngs = ExperimentRngs(run=1)
    other = eng._chaos_masks(0, 2)
    want = make_chaos_masks(eng.chaos, ExperimentRngs(run=1).chaos_key(),
                            0, 2, N)
    for x, y in zip(other, want):
        np.testing.assert_array_equal(x, y)
