"""The port's malicious aggregator (fedmse_tpu_torch/federation/attack.py)
against the JAX package's (fedmse_tpu/federation/attack.py), case by case
with tests/test_attack.py:

  * the spec's validation, with the JAX package's messages;
  * the schedule (every_k, the stop_round burst) round by round;
  * the deterministic poisons (scale, sign_flip, zero) within 1e-5 of
    JAX's on the same params, and the noise attack on JAX's exported draw;
  * engines from one init (tools in tests/torch_fault_common.py): a scale
    attack is rejected after first contact on both paths, as by the JAX
    engine; blocked models keep their params; an honest run rejects
    nothing; a burst that stops diverges from one that does not; a noise
    attack on JAX's per-round draws matches the JAX fused engine within
    1e-5; the fused and the per-phase round poison with the same numbers
    (bit for bit on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.federation import AttackSpec as JaxSpec
from fedmse_tpu.federation import make_poison_fn as jax_make_poison_fn
from fedmse_tpu.federation import poison_params as jax_poison_params
from fedmse_tpu.models import init_client_params, make_model as jax_model
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.federation.attack import (ATTACK_KINDS, AttackSpec,
                                                attack_active, make_poison_fn,
                                                noise_draws, poison_params)
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import (DIMS, N, assert_matches_jax,
                                      assert_same_round, assert_same_states,
                                      flat, pair, port_cfg, port_engine)

torch.set_num_threads(1)


def _jax_params():
    return init_client_params(jax_model("hybrid", *DIMS, 1.0),
                              jax.random.key(0))


def _flat1(tree) -> torch.Tensor:
    """One model's JAX tree as the port's flat [P]."""
    return flat(jax.tree.map(lambda t: np.asarray(t)[None], tree))[0]


@pytest.mark.parametrize("kw", [
    dict(kind="meteor"), dict(kind="scale", every_k=0),
    dict(kind="scale", start_round=2, stop_round=2),
    dict(kind="scale", start_round=5, stop_round=3)])
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        AttackSpec(**kw)
    assert str(got.value) == str(want.value)
    AttackSpec(kind="scale", start_round=2, stop_round=5)
    assert ATTACK_KINDS == ("scale", "noise", "sign_flip", "zero")


@pytest.mark.parametrize("kw", [
    dict(every_k=2, start_round=0), dict(start_round=1, stop_round=3),
    dict(every_k=2, start_round=0, stop_round=4),
    dict(every_k=3, start_round=2)])
def test_schedule_matches_jax(kw):
    """attack_active per absolute round == whether JAX's poison_fn fires."""
    spec = dict(kind="scale", strength=50.0, **kw)
    fn = jax_make_poison_fn(JaxSpec(**spec))
    one = {"w": jnp.ones(())}
    for r in range(9):
        fired = float(fn(one, jnp.asarray(r), jax.random.key(1))["w"]) == 50
        assert attack_active(AttackSpec(**spec), r) == fired, r
    np.testing.assert_array_equal(
        make_poison_fn(AttackSpec(**spec)).active(0, 9),
        [attack_active(AttackSpec(**spec), r) for r in range(9)])


@pytest.mark.parametrize("kind", ["scale", "sign_flip", "zero", "noise"])
def test_poisons_match_jax(kind):
    """The poisons on the same params within 1e-5; the noise attack on the
    standard normals JAX drew (poison of a zero model, strength 1)."""
    params = _jax_params()
    key = jax.random.key(7)
    want = _flat1(jax_poison_params(params, JaxSpec(kind=kind, strength=3.0),
                                    key))
    noise = _flat1(jax_poison_params(jax.tree.map(jnp.zeros_like, params),
                                     JaxSpec(kind="noise", strength=1.0),
                                     key))
    got = poison_params(_flat1(params), AttackSpec(kind=kind, strength=3.0),
                        noise)
    scale = float(want.abs().max().clamp_min(1e-30))
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1.0)
    if kind == "zero":
        assert not got.any()


def test_poison_fn_selects_on_the_device_bit():
    merged = torch.arange(5, dtype=torch.float32)
    fn = make_poison_fn(AttackSpec(kind="scale", strength=2.0))
    assert torch.equal(fn(merged, torch.tensor(1.0)), 2 * merged)
    assert torch.equal(fn(merged, torch.tensor(0.0)), merged)
    with pytest.raises(ValueError, match="noise"):
        poison_params(merged, AttackSpec(kind="noise"))


def test_noise_draws_are_per_round_and_domain_separated():
    """Row r depends on round start + r alone; the attack stream is none of
    the run's other streams and consumes nothing from them."""
    rngs = ExperimentRngs(run=0)
    gen, sel = rngs.generator.get_state(), rngs.select_rng.getstate()
    key = rngs.attack_key()
    whole = noise_draws(key, 0, 6, 10)
    np.testing.assert_array_equal(noise_draws(key, 3, 2, 10), whole[3:5])
    assert torch.equal(rngs.generator.get_state(), gen)
    assert rngs.select_rng.getstate() == sel
    assert len({rngs.attack_key(), rngs.chaos_key(), rngs.elastic_key(),
                ExperimentRngs(run=1).attack_key()}) == 4
    assert not np.array_equal(noise_draws(ExperimentRngs(run=1).attack_key(),
                                          0, 6, 10), whole)


@pytest.mark.parametrize("fused", [True, False])
def test_scale_attack_rejected_after_first_contact(fused):
    """Round 0 is clean (start_round 1) and accepted; every later attacked
    round adds a rejection for each verified receiver: the rows and
    counters equal the JAX engine's, the states within 1e-5."""
    attack = dict(kind="scale", strength=50.0, start_round=1)
    jeng, teng = pair(attack=attack, fused=fused, update_type="avg")
    jres = [jeng.run_round(r) for r in range(4)]
    tres = [teng.run_round(r) for r in range(4)]
    assert all(row["rejected_updates"] == 0
               for row in tres[0].verification_results)
    counts = [max(row["rejected_updates"] for row in r.verification_results)
              for r in tres[1:] if r.aggregator is not None]
    assert counts and counts[-1] >= 2 and counts == sorted(counts)
    assert_matches_jax(jres, tres, jeng, teng)


def test_attack_blocked_models_keep_prior_params():
    """A zero attack at round 1: a verified receiver rejects it and keeps
    its params; a first-contact receiver loads even the zero model."""
    eng = port_engine(update_type="avg",
                      poison_fn=make_poison_fn(AttackSpec(kind="zero",
                                                          start_round=1)))
    eng.run_round(0)
    seen = eng.states.hist_seen.clone()
    res = eng.run_round(1)
    assert res.aggregator is not None
    for i in range(N):
        if i == res.aggregator:
            continue
        row = eng.states.params[i]
        if seen[i]:
            assert int(eng.states.rejected[i]) == 1
            assert float(row.abs().max()) > 0.0
        else:
            assert int(eng.states.rejected[i]) == 0
            assert float(row.abs().max()) == 0.0


def test_honest_run_has_no_rejections():
    eng = port_engine(update_type="avg")
    for r in range(3):
        res = eng.run_round(r)
    assert all(row["rejected_updates"] == 0
               for row in res.verification_results)


def test_transient_attack_stop_round_threads_through_engine():
    """A burst stopping at round 3 and an attack that never stops share the
    rounds 0-2 bit for bit, then their states part."""
    def run(stop_round):
        spec = AttackSpec(kind="scale", strength=50.0, start_round=1,
                          stop_round=stop_round)
        eng = port_engine(update_type="avg", poison_fn=make_poison_fn(spec))
        return [eng.run_round(r) for r in range(6)], eng

    burst, beng = run(3)
    forever, feng = run(None)
    for a, b in zip(burst[:3], forever[:3]):
        assert_same_round(a, b)
    assert any(forever[r].aggregator is not None for r in range(3, 6))
    assert not torch.equal(beng.states.params, feng.states.params)


def _jax_round_noise(n_rounds, strength=1.0):
    """The standard normals the JAX fused engine's noise attack adds in
    rounds 0..n-1 (its round keys: the init takes the run's first fold,
    round r the (r + 2)-th; the poison folds 0x7FFFFFFF into it)."""
    rngs = JaxRngs(run=0)
    rngs.next_jax()
    keys = rngs.next_jax_batch(n_rounds)
    zeros = jax.tree.map(jnp.zeros_like, _jax_params())
    return np.stack([_flat1(jax_poison_params(
        zeros, JaxSpec(kind="noise", strength=strength),
        jax.random.fold_in(keys[r], 0x7FFFFFFF))).numpy()
        for r in range(n_rounds)])


def test_noise_attack_on_jax_draws_matches_jax_engine():
    attack = dict(kind="noise", strength=0.5, start_round=1)
    jeng, teng = pair(attack=attack)
    noise = _jax_round_noise(3)
    active = teng.poison_fn.active
    teng._attack_inputs = lambda start, n: {
        "attack": active(start, n), "noise": noise[start:start + n]}
    jres, tres = jeng.run_rounds(0, 3), teng.run_rounds(0, 3)
    assert any(r.aggregator is not None for r in tres[1:])
    assert_matches_jax(jres, tres, jeng, teng)


@pytest.mark.parametrize("kind", ["noise", "sign_flip"])
def test_fused_and_per_phase_poison_alike(kind):
    """The attack bit and noise of round r are the same on both paths: the
    fused round and the per-phase round stay bit-equal under attack."""
    spec = AttackSpec(kind=kind, strength=0.5, start_round=1)
    per = port_engine(fused=False, poison_fn=make_poison_fn(spec))
    fus = port_engine(fused=True, states=per.states.clone(),
                      poison_fn=make_poison_fn(spec))
    for r in range(3):
        assert_same_round(fus.run_round(r), per.run_round(r),
                          observables=False)
        assert_same_states(fus.states, per.states)


def test_attack_needs_no_fused_round():
    """Only chaos and elastic membership refuse the per-phase path."""
    eng = port_engine(cfg=port_cfg(), fused=False, profile=True,
                      poison_fn=make_poison_fn(AttackSpec()))
    assert eng.run_round(0).phase_seconds is not None
