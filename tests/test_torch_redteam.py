"""The port's red team, round half (fedmse_tpu_torch/redteam/ and its hooks in
federation/{voting,fused,rounds}.py) against the JAX package's, at width
16 / 8 / 3:

  * the spec: validation messages, `is_null`, `attacks` and `signature()`
    as the JAX package's (tests/test_redteam.py's cases);
  * the masks: explicit-id coalitions equal to JAX's, the tenure gate equal
    on an exported membership timeline, the port's own frac draw
    padding-invariant and in a stream of its own;
  * the poisons: `_poison_rows` and `_poison_tree` in all three kinds
    within 1e-6 of JAX's on the same params and noise;
  * the election with `vote_ok`, `adv` and `lie_votes` against the JAX
    `_elect_on_device`: the same aggregator, scores within 1e-5, and the
    gate before the collusion pick;
  * 2 fused rounds against the JAX RoundEngine(fused=True, redteam=) from
    one init, with JAX's masks, timelines and noise fed to the port: a
    clustered merge-stage poison at K = 2, a sybil coalition under
    elastic joins with min_tenure, and a noise update-stage attack; params
    within 1e-5 scale-normalized, the same aggregators;
  * a null spec bit-equal to no spec with the same bodies, the per-phase
    engine's refusal, and a chunk equal to its rounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.cluster import ClusterSpec as JaxClusterSpec
from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.data.synthetic import synthetic_typed_clients as jax_typed
from fedmse_tpu.federation import ElasticSpec as JaxElasticSpec
from fedmse_tpu.federation import RoundEngine as JaxEngine
from fedmse_tpu.federation.elastic import MembershipMasks as JaxMasks
from fedmse_tpu.federation.fused import _elect_on_device as jax_elect
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.redteam import RedteamSpec as JaxSpec
from fedmse_tpu.redteam import adversary as jax_adv
from fedmse_tpu.redteam import make_redteam_masks as jax_make_masks
from fedmse_tpu.redteam import tenure_vote_ok as jax_tenure
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.cluster import ClusterSpec
from fedmse_tpu_torch.data import (stack_clients, synthetic_clients,
                                   synthetic_typed_clients)
from fedmse_tpu_torch.federation import (RoundEngine,
                                         client_states_from_numpy)
from fedmse_tpu_torch.federation.elastic import ElasticSpec, MembershipMasks
from fedmse_tpu_torch.federation.voting import elect_on_device
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.redteam import (RedteamMasks, RedteamSpec,
                                      assignment_capture_rate,
                                      coalition_mask, make_redteam_fns,
                                      make_redteam_masks, merge_noise,
                                      mimic_latent_stats, tenure_vote_ok,
                                      update_noise)
from fedmse_tpu_torch.redteam import adversary as adv_mod
from fedmse_tpu_torch.redteam import mimicry
from fedmse_tpu_torch.utils.seeding import ExperimentRngs
from tests.torch_fault_common import (BASE, DIMS, LAYOUT, N,
                                      assert_same_round, assert_same_states,
                                      flat, leaf_err, port_cfg, port_engine)

torch.set_num_threads(1)

# ------------------------------------------------------------- the spec ----

BAD_SPECS = [
    dict(kind="zero"), dict(poison="typo"), dict(adversary_frac=1.5),
    dict(kind="sybil", adversaries=()),
    dict(kind="sybil", adversaries=(1, 1)),
    dict(kind="sybil", adversaries=(-1,)),
    dict(kind="cluster_poison"),
    dict(kind="sybil", adversaries=(0,), every_k=0),
    dict(kind="sybil", adversaries=(0,), start_round=-1),
    dict(kind="sybil", adversaries=(0,), start_round=3, stop_round=3),
    dict(victim_cluster=-1), dict(mimic_blend=1.5), dict(min_tenure=-1),
]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as got:
        RedteamSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(min_tenure=2),
    dict(kind="sybil", adversaries=(0, 3), lie_votes=True, min_tenure=6),
    dict(kind="cluster_poison", adversary_frac=0.25, victim_cluster=1,
         poison="noise", strength=0.5, every_k=2, start_round=1,
         stop_round=9, mimic_blend=0.8),
])
def test_signature_null_and_attacks_match_jax(kw):
    ours, theirs = RedteamSpec(**kw), JaxSpec(**kw)
    assert ours.signature() == theirs.signature()
    assert (ours.is_null, ours.attacks) == (theirs.is_null, theirs.attacks)


def test_null_and_defense_only_fns():
    assert make_redteam_fns(None) is None
    assert make_redteam_fns(RedteamSpec()) is None
    fns = make_redteam_fns(RedteamSpec(min_tenure=2))
    assert fns.update_fn is None and fns.merge_fn is None
    assert fns.gate_votes and not fns.lie_votes and not fns.needs_noise
    fns = make_redteam_fns(RedteamSpec(kind="sybil", adversaries=(1,),
                                       lie_votes=True, min_tenure=1))
    assert fns.update_fn is not None and fns.lie_votes and fns.gate_votes


# ------------------------------------------------------------ the masks ----

def test_explicit_coalition_matches_jax():
    spec = dict(kind="sybil", adversaries=(1, 9, 3))
    want = jax_make_masks(JaxSpec(**spec), JaxRngs(run=0).redteam_key(), 3,
                          6)
    got = make_redteam_masks(RedteamSpec(**spec),
                             ExperimentRngs(run=0).redteam_key(), 3, 6)
    np.testing.assert_array_equal(got.adv, np.asarray(want.adv))
    np.testing.assert_array_equal(got.vote_ok, np.asarray(want.vote_ok))
    np.testing.assert_array_equal(got.adv[0], [0, 1, 0, 1, 0, 0])


def test_tenure_gate_matches_jax_on_an_exported_timeline():
    espec = dict(leave_p=0.3, join_p=0.6, preempt_p=0.1)
    jeng = _jax_engine(elastic=espec)
    timeline = jeng._elastic_masks(0, 8)
    ours = MembershipMasks(*(np.asarray(m) for m in timeline))
    assert ours.generation.max() > 0  # recycled tenants to gate
    for tenure in (1, 2, 4):
        np.testing.assert_array_equal(tenure_vote_ok(tenure, ours, 8, N),
                                      jax_tenure(tenure, timeline, 8, N))
    want = jax_make_masks(JaxSpec(kind="sybil", adversaries=(2,),
                                  min_tenure=2),
                          JaxRngs(run=0).redteam_key(), 8, N,
                          membership=timeline)
    got = make_redteam_masks(RedteamSpec(kind="sybil", adversaries=(2,),
                                         min_tenure=2),
                             ExperimentRngs(run=0).redteam_key(), 8, N,
                             membership=ours)
    np.testing.assert_array_equal(got.vote_ok, np.asarray(want.vote_ok))
    with pytest.raises(ValueError, match="membership"):
        make_redteam_masks(RedteamSpec(min_tenure=2),
                           ExperimentRngs(run=0).redteam_key(), 4, N)


def test_frac_coalition_is_padding_invariant_and_its_own_stream():
    spec = RedteamSpec(kind="sybil", adversary_frac=0.5)
    rngs = ExperimentRngs(run=0)
    a = coalition_mask(spec, rngs.redteam_key(), 8)
    b = coalition_mask(spec, rngs.redteam_key(), 12)
    np.testing.assert_array_equal(a, b[:8])
    assert 0 < a.sum() < 8
    # drawing consumes nothing: the torch and selection streams are where
    # a fresh run's are
    fresh = ExperimentRngs(run=0)
    assert rngs.select_rng.random() == fresh.select_rng.random()
    assert torch.equal(torch.rand(4, generator=rngs.generator),
                       torch.rand(4, generator=fresh.generator))
    other = ExperimentRngs(run=1).redteam_key()
    assert len({rngs.redteam_key(), rngs.chaos_key(), rngs.elastic_key(),
                rngs.attack_key(), other}) == 5


def test_noise_streams_are_per_round_and_per_client():
    key = ExperimentRngs(run=0).redteam_key()
    u = update_noise(key, 2, 2, 3, 5)
    np.testing.assert_array_equal(u[1], update_noise(key, 3, 1, 3, 5)[0])
    np.testing.assert_array_equal(u[:, :2], update_noise(key, 2, 2, 2, 5))
    m = merge_noise(key, 0, 3, 10)
    np.testing.assert_array_equal(m[:, :4], merge_noise(key, 0, 3, 4))
    assert not np.array_equal(u[0, 0], m[2, :5])


def test_mimicry_is_the_jax_function():
    from fedmse_tpu.redteam import mimicry as jax_mimicry
    rng = np.random.default_rng(3)
    means = rng.normal(size=(6, 3)).astype(np.float32)
    q = rng.normal(size=(6, 3, 3))
    covs = (np.einsum("gij,gkj->gik", q, q) + np.eye(3)).astype(np.float32)
    args = (means, covs, (1, 4), means[0], covs[0], 0.7)
    for got, want in zip(mimic_latent_stats(*args),
                         jax_mimicry.mimic_latent_stats(*args)):
        np.testing.assert_array_equal(got, want)
    a = np.array([0, 1, 0, 1, 0, 0])
    assert assignment_capture_rate(a, (1, 3, 4), 1) == \
        jax_mimicry.assignment_capture_rate(a, (1, 3, 4), 1)
    assert mimicry.assignment_capture_rate(a, (), 1) == 0.0


# ---------------------------------------------------------- the poisons ----

UNIT = JaxSpec(kind="sybil", adversaries=(0,), poison="noise", strength=1.0)


def _jax_tree(rng, g):
    """A random JAX [g, ...] param tree and its flat [g, P] twin."""
    params = torch.from_numpy(rng.normal(size=(g, LAYOUT.size)).astype(
        np.float32))
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        LAYOUT.tree(params)), params


def _lead(tree):
    return jax.tree.map(lambda t: t[None], tree)


def _rows_noise(tree, key, rows):
    """The normals JAX's noise poison adds to the `rows` [G] rows of a
    [G, ...] tree under `key`, flat [G, P]."""
    zeros = jax.tree.map(jnp.zeros_like, tree)
    return flat(jax_adv._poison_rows(UNIT, zeros, jnp.asarray(rows), key))


def _tree_noise(one, key):
    """The normals JAX's noise poison adds to one merged model, flat
    [P]."""
    zeros = jax.tree.map(jnp.zeros_like, one)
    return flat(_lead(jax_adv._poison_tree(UNIT, zeros, key, False)))[0]


@pytest.mark.parametrize("poison", ["scale", "sign_flip", "noise"])
def test_poison_rows_and_tree_match_jax(poison):
    rng = np.random.default_rng(1)
    tree, params = _jax_tree(rng, 5)
    key = jax.random.key(4)
    adv = np.array([0, 1, 0, 1, 1], np.float32)
    kw = dict(kind="cluster_poison", adversaries=(1,), poison=poison,
              strength=0.75)
    got = adv_mod._poison_rows(RedteamSpec(**kw), params,
                               torch.from_numpy(adv),
                               _rows_noise(tree, key, np.ones(5)))
    want = flat(jax_adv._poison_rows(JaxSpec(**kw), tree, jnp.asarray(adv),
                                     key))
    assert leaf_err(got, want) <= 1e-6
    honest = torch.from_numpy(adv == 0)
    assert torch.equal(got[honest], params[honest])  # bit for bit
    # one merged model [P]
    one = jax.tree.map(lambda t: t[0], tree)
    got = adv_mod._poison_tree(RedteamSpec(**kw), params[0],
                               _tree_noise(one, key))
    want = flat(_lead(jax_adv._poison_tree(JaxSpec(**kw), one, key,
                                           False)))[0]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    # the victim row of [K, P] cluster merges; the others untouched
    kv = dict(kw, victim_cluster=2)
    tree3 = jax.tree.map(lambda t: t[:3], tree)
    got = adv_mod._poison_tree(RedteamSpec(**kv), params[:3],
                               _rows_noise(tree3, key, [0.0, 0.0, 1.0]),
                               clustered=True)
    want = flat(jax_adv._poison_tree(JaxSpec(**kv), tree3, key, True))
    assert leaf_err(got[2:], want[2:]) <= 1e-6
    assert torch.equal(got[:2], params[:2])


def test_hooks_fire_only_on_their_rounds():
    spec = RedteamSpec(kind="cluster_poison", adversaries=(1,),
                       poison="scale", strength=100.0, start_round=2,
                       every_k=2, stop_round=7)
    fns = make_redteam_fns(spec)
    np.testing.assert_array_equal(fns.active(0, 9),
                                  [0, 0, 1, 0, 1, 0, 1, 0, 0])
    params = torch.ones(4, 3)
    adv = torch.tensor([0.0, 1.0, 0.0, 0.0])
    off = fns.update_fn(params, adv, torch.tensor(0.0))
    assert torch.equal(off, params)
    on = fns.update_fn(params, adv, torch.tensor(1.0))
    assert torch.equal(on[1], torch.full((3,), 100.0))
    assert torch.equal(on[[0, 2, 3]], params[[0, 2, 3]])
    merged = torch.ones(3)
    assert torch.equal(fns.merge_fn(merged, torch.tensor(False),
                                    torch.tensor(1.0)), merged)
    assert torch.equal(fns.merge_fn(merged, torch.tensor(True),
                                    torch.tensor(1.0)), merged * 100.0)


# --------------------------------------------------------- the election ----

def _elect_both(scores, sel, mask=None, count=None, vote_ok=None, adv=None,
                lie=False):
    n = len(scores)
    scores = np.asarray(scores, np.float32)
    mask = np.ones(n, np.float32) if mask is None else np.asarray(
        mask, np.float32)
    count = np.zeros(n, np.int32) if count is None else np.asarray(
        count, np.int32)

    def f32(x):
        return None if x is None else np.asarray(x, np.float32)
    want_agg, want_scores = jax_elect(
        lambda *a: jnp.asarray(scores), None, jnp.asarray(sel, jnp.int32),
        jnp.asarray(mask), jnp.asarray(count), jnp.zeros((2, 2)),
        jnp.ones((2,)), jax.random.key(0), 3,
        vote_ok=None if vote_ok is None else jnp.asarray(f32(vote_ok)),
        adv=None if adv is None else jnp.asarray(f32(adv)), lie_votes=lie)
    got_agg, got_scores = elect_on_device(
        torch.from_numpy(scores), None, torch.tensor(sel),
        torch.from_numpy(mask), torch.from_numpy(count), 3,
        voters=torch.from_numpy(mask),
        vote_ok=None if vote_ok is None else torch.from_numpy(f32(vote_ok)),
        adv=None if adv is None else torch.from_numpy(f32(adv)),
        lie_votes=lie)
    assert int(got_agg) == int(want_agg)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5, atol=0)
    return int(got_agg)


def test_lying_voter_and_tenure_gate_match_jax():
    scores, sel = [0.9, 0.5, 0.1, 0.7], [0, 1, 2, 3]
    assert _elect_both(scores, sel) == 2
    assert _elect_both(scores, sel, adv=[1, 0, 0, 1], lie=True) == 3
    assert _elect_both(scores, sel, adv=[0, 0, 0, 1], lie=True) == 2
    # the gate comes before the collusion pick: a gated accomplice
    assert _elect_both(scores, sel, adv=[1, 0, 0, 1], vote_ok=[1, 1, 1, 0],
                       lie=True) == 2
    # a gated voter casts no vote: its turn passes
    assert _elect_both(scores, sel, adv=[1, 0, 0, 1], vote_ok=[0, 1, 1, 1],
                       lie=True) == 2
    # lie_votes off: adv is ignored
    assert _elect_both(scores, sel, adv=[1, 0, 0, 1]) == 2


@pytest.mark.parametrize("seed", range(6))
def test_election_matches_jax_on_random_cases(seed):
    rng = np.random.default_rng(seed)
    n = 7
    scores = rng.uniform(size=n).astype(np.float32)
    scores[rng.integers(n)] = np.nan
    sel = rng.permutation(n)[:4].tolist()
    mask = np.zeros(n)
    mask[sel] = rng.uniform(size=4) > 0.2
    count = rng.integers(0, 4, size=n)
    vote_ok = (rng.uniform(size=n) > 0.3).astype(np.float32)
    adv = (rng.uniform(size=n) > 0.5).astype(np.float32)
    for kw in (dict(vote_ok=vote_ok), dict(adv=adv, lie=True),
               dict(vote_ok=vote_ok, adv=adv, lie=True)):
        _elect_both(scores, sel, mask=mask, count=count, **kw)


# ------------------------------------------------------- the red rounds ----

def _jax_engine(elastic=None, **kw):
    cfg = JaxConfig(**BASE, compat=JaxCompat(vote_tie_break=False))
    clients = jax_synthetic(n_clients=N, dim=16, n_normal=240,
                            n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    if elastic is not None:
        kw["elastic"] = JaxElasticSpec(**elastic)
    return JaxEngine(jax_make_model("hybrid", *DIMS, cfg.shrink_lambda), cfg,
                     jax_stack(clients, dev_x, 12), n_real=N,
                     rngs=JaxRngs(run=0), model_type="hybrid",
                     update_type="mse_avg", fused=True, **kw)


def red_pair(spec_kw, *, typed=False, cluster=None, elastic=None,
             horizon=2, **cfg_kw):
    """(JAX engine, port engine) from one init and data under RedteamSpec
    `spec_kw`, the JAX engine's red-team masks (and elastic timeline) fed
    to the port."""
    n = 8 if typed else N
    cfg_kw = {**cfg_kw, "network_size": n}
    data_kw = dict(n_clients=n, dim=16, n_normal=240, n_abnormal=120, seed=0)
    if typed:
        data_kw["types"] = 2
        jclients = jax_typed(**data_kw)
        tclients = synthetic_typed_clients(**data_kw)
    else:
        jclients, tclients = jax_synthetic(**data_kw), synthetic_clients(
            **data_kw)
    dev_x = np.concatenate([c.dev_raw for c in tclients])[:200].astype(
        np.float32)
    jhooks = {"redteam": JaxSpec(**spec_kw)}
    thooks = {"redteam": RedteamSpec(**spec_kw)}
    if cluster is not None:
        spec, assignment = cluster
        jhooks["cluster"] = JaxClusterSpec(**spec)
        thooks["cluster"] = ClusterSpec(**spec)
        jhooks["cluster_assignment"] = thooks["cluster_assignment"] = \
            np.asarray(assignment, np.int32)
    if elastic is not None:
        jhooks["elastic"] = JaxElasticSpec(**elastic)
        thooks["elastic"] = ElasticSpec(**elastic)
    jcfg = JaxConfig(**{**BASE, **cfg_kw},
                     compat=JaxCompat(vote_tie_break=False))
    jeng = JaxEngine(jax_make_model("hybrid", *DIMS, jcfg.shrink_lambda),
                     jcfg, jax_stack(jclients, dev_x, 12), n_real=n,
                     rngs=JaxRngs(run=0), model_type="hybrid",
                     update_type="mse_avg", fused=True, **jhooks)
    if elastic is not None:
        thooks["elastic_masks"] = MembershipMasks(*(
            np.asarray(m) for m in jeng._elastic_masks(0, horizon)))
    thooks["redteam_masks"] = RedteamMasks(*(
        np.asarray(m) for m in jeng._redteam_masks(0, horizon)))
    init = client_states_from_numpy(jax.tree.map(np.array, jeng.states),
                                    LAYOUT, device="cpu")
    tcfg = port_cfg(**cfg_kw)
    teng = RoundEngine(make_model("hybrid", *DIMS, tcfg.shrink_lambda,
                                  device="cpu"), tcfg,
                       stack_clients(tclients, dev_x, 12, device="cpu"),
                       n_real=n, rngs=ExperimentRngs(run=0),
                       model_type="hybrid", update_type="mse_avg",
                       states=init, fused=True, **thooks)
    return jeng, teng


def _feed_jax_noise(jeng, teng, horizon):
    """Replace the port's red-team noise with the JAX engine's draws: its
    round keys (the init takes the run's first fold, round r the
    (r + 2)-th) folded with the two stage constants."""
    rngs = JaxRngs(run=0)
    rngs.next_jax()
    keys = rngs.next_jax_batch(horizon)
    params = jeng.states.params
    one = jax.tree.map(lambda t: t[0], params)
    upd = np.stack([_rows_noise(params, jax.random.fold_in(
        keys[r], jax_adv.UPDATE_POISON_FOLD), np.ones(jeng.n_pad)).numpy()
        for r in range(horizon)])
    mrg = np.stack([_tree_noise(one, jax.random.fold_in(
        keys[r], jax_adv.MERGE_POISON_FOLD)).numpy()
        for r in range(horizon)])
    teng._redteam_noise = lambda start, k: {
        "rt_update_noise": upd[start:start + k],
        "rt_merge_noise": mrg[start:start + k]}


def _assert_rounds_match(jeng, teng, jres, tres, tol=1e-5):
    for want, got in zip(jres, tres):
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
    for name in ("params", "prev_global", "hist_params"):
        assert leaf_err(getattr(teng.states, name),
                        flat(getattr(jeng.states, name))) <= tol, name
    np.testing.assert_array_equal(teng.states.rejected.numpy(),
                                  np.asarray(jeng.states.rejected))


def test_clustered_merge_poison_matches_jax():
    """cluster_poison at K = 2: the coalition's own updates scaled each
    round and, when one of them is elected, the victim cluster's merge
    sign-flipped."""
    jeng, teng = red_pair(
        dict(kind="cluster_poison", adversaries=(0, 2, 5), poison="sign_flip",
             strength=1.5, victim_cluster=1),
        typed=True, cluster=(dict(k=2), [1, 0, 1, 0, 1, 0, 1, 0]))
    jres, tres = jeng.run_rounds(0, 2), teng.run_rounds(0, 2)
    assert any(r.aggregator is not None for r in tres)
    _assert_rounds_match(jeng, teng, jres, tres)
    assert teng.fused_round().clustered


def test_sybil_with_elastic_and_min_tenure_matches_jax():
    """Every client votes; in round 2 the first voter (slot 1) is a sybil
    whose accomplice (slot 3, just joined) is tenure-gated, so it makes
    the honest pick."""
    spec = dict(kind="sybil", adversaries=(1, 3), lie_votes=True,
                min_tenure=2)
    jeng, teng = red_pair(spec, elastic=dict(leave_p=0.2, join_p=0.5),
                          num_participants=1.0)
    jres, tres = jeng.run_rounds(0, 2), teng.run_rounds(0, 2)
    _assert_rounds_match(jeng, teng, jres, tres)
    masks = teng._redteam_masks(0, 2)
    assert masks.vote_ok[1, 3] == 0 and tres[1].selected[0] == 1
    assert [r.aggregator for r in tres] == [0, 2]


def test_noise_update_attack_on_jax_draws_matches_jax():
    jeng, teng = red_pair(dict(kind="cluster_poison", adversaries=(1, 2),
                               poison="noise", strength=0.05))
    _feed_jax_noise(jeng, teng, 2)
    jres, tres = jeng.run_rounds(0, 2), teng.run_rounds(0, 2)
    _assert_rounds_match(jeng, teng, jres, tres)


# ------------------------------------------------------- the red engine ----

def test_null_spec_is_bit_equal_to_no_spec():
    plain = port_engine()
    null = port_engine(states=plain.states.clone(), redteam=RedteamSpec())
    for a, b in zip(plain.run_rounds(0, 3), null.run_rounds(0, 3)):
        assert_same_round(b, a)
    assert_same_states(null.states, plain.states)
    assert null.redteam is None
    fp, fn = plain.fused_round(), null.fused_round()
    assert fn.redteam is None and fn.input_names == fp.input_names


def test_attack_changes_states_and_a_chunk_is_its_rounds():
    spec = RedteamSpec(kind="cluster_poison", adversaries=(1,),
                       poison="noise", strength=0.5)
    off = port_engine()
    ea = port_engine(states=off.states.clone(), redteam=spec)
    eb = port_engine(states=off.states.clone(), redteam=spec)
    off.run_rounds(0, 3)
    for r in range(3):
        ea.run_round_fused(r)
    eb.run_rounds(0, 3)
    assert not torch.equal(off.states.params, ea.states.params)
    assert_same_states(ea.states, eb.states)


def test_redteam_needs_the_fused_round_and_elastic_for_tenure():
    cfg = port_cfg()
    for kw in (dict(fused=False), dict(fused=True, profile=True)):
        with pytest.raises(ValueError, match="fused"):
            port_engine(cfg, redteam=RedteamSpec(kind="sybil",
                                                 adversaries=(1,)), **kw)
    with pytest.raises(ValueError, match="ElasticSpec"):
        port_engine(cfg, redteam=RedteamSpec(min_tenure=2))
    with pytest.raises(ValueError, match="RedteamSpec"):
        port_engine(cfg, redteam_masks=RedteamMasks(
            np.zeros((2, N), np.float32), np.ones((2, N), np.float32)))
    # a null spec builds nothing and runs on the per-phase path too
    port_engine(cfg, fused=False, redteam=RedteamSpec()).run_round(0)


# ------------------------------------------------------ serving roster ----
# the swap cases of tests/test_elastic.py on the port's engine, with the
# roster's cluster column

def _serving_setup(**kw):
    from fedmse_tpu_torch.models.autoencoder import init_stacked_params
    from fedmse_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(0)
    model = make_model("hybrid", *DIMS, 1.0, device="cpu")
    params = init_stacked_params(model, N, torch.Generator().manual_seed(0),
                                 device="cpu")
    train_x = rng.normal(size=(N, 60, DIMS[0])).astype(np.float32)
    eng = ServingEngine.from_federation(model, "hybrid", params,
                                        train_x=train_x, max_bucket=32,
                                        device="cpu", **kw)
    rows = rng.normal(size=(64, DIMS[0])).astype(np.float32)
    return model, params, train_x, eng, rows


def test_roster_cluster_column_and_full():
    from fedmse_tpu.serving import ServingRoster as JaxRoster
    from fedmse_tpu_torch.serving import ServingRoster
    full = ServingRoster.full(N)
    want = JaxRoster.full(N)
    np.testing.assert_array_equal(full.member, want.member)
    np.testing.assert_array_equal(full.generation, want.generation)
    assert full.cluster is None and full.num_gateways == N
    r = ServingRoster(member=[1, 1, 0, 1], generation=[0, 2, 1, 0],
                      cluster=[1, 0, 1, 0])
    assert r.cluster.dtype == np.int32 and r.member.dtype == bool
    for kw in (dict(generation=np.zeros(3)),
               dict(generation=np.zeros(N), cluster=np.zeros(3))):
        with pytest.raises(ValueError) as got:
            ServingRoster(member=np.ones(N, bool), **kw)
        with pytest.raises(ValueError) as want:
            JaxRoster(member=np.ones(N, bool), **kw)
        assert str(got.value) == str(want.value)


def test_unknown_gateway_fails_loudly_at_dispatch():
    from fedmse_tpu_torch.serving import ServingRoster, UnknownGatewayError
    # membership, not the cluster column, decides who serves
    roster = ServingRoster(member=np.asarray([True, True, False, True]),
                           generation=np.zeros(N, np.int64),
                           cluster=np.asarray([0, 1, 0, 1]))
    _, _, _, eng, rows = _serving_setup(roster=roster)
    eng.score(rows[:4], np.asarray([0, 1, 3, 0], np.int32))
    with pytest.raises(UnknownGatewayError, match="UNKNOWN_GATEWAY"):
        eng.score(rows[:4], np.asarray([0, 2, 3, 0], np.int32))
    with pytest.raises(UnknownGatewayError, match="UNKNOWN_GATEWAY"):
        eng.dispatch(rows[:2], np.asarray([2, 2], np.int32))
    assert UnknownGatewayError.verdict == "UNKNOWN_GATEWAY"
    _, _, _, open_eng, _ = _serving_setup()  # no roster: every slot serves
    open_eng.score(rows[:2], np.asarray([2, 2], np.int32))


def test_roster_swap_and_recycle_through_the_batcher():
    """A roster swap closes the forming batch (its rows were admitted under
    the outgoing roster), the intake rejects a retired slot from the next
    submit, and a recycled slot's params in the same swap serve its new
    tenant: every ticket is scored exactly once."""
    from fedmse_tpu_torch.models.autoencoder import init_stacked_params
    from fedmse_tpu_torch.serving import (ContinuousBatcher, ServingEngine,
                                          ServingRoster, UnknownGatewayError)
    model, params, train_x, eng, rows = _serving_setup(
        roster=ServingRoster.full(N))
    gws_pre = np.asarray([i % N for i in range(8)], np.int32)
    want_old = eng.score(rows[:8], gws_pre)
    front = ContinuousBatcher(eng, max_batch=16, latency_budget_ms=1e9)
    pre = [front.submit(rows[i], int(gws_pre[i])) for i in range(8)]
    left = ServingRoster(member=np.asarray([True, True, False, True]),
                         generation=np.zeros(N, np.int64),
                         cluster=np.asarray([0, 1, 0, 1]))
    event = front.swap(roster=left)
    assert event["kinds"] == ["roster"]
    assert event["roster_delta"]["left"] == [2]
    assert front.forming_rows == 0 and front.in_flight_rows == 8
    assert eng.roster.cluster.tolist() == [0, 1, 0, 1]  # carried through
    with pytest.raises(UnknownGatewayError, match="UNKNOWN_GATEWAY"):
        front.submit(rows[8], 2)
    with pytest.raises(UnknownGatewayError, match="UNKNOWN_GATEWAY"):
        front.submit_many(rows[8:12], np.asarray([0, 1, 2, 3], np.int32))
    assert front.forming_rows == 0
    params2 = init_stacked_params(model, N, torch.Generator().manual_seed(7),
                                  device="cpu")
    eng2 = ServingEngine.from_federation(model, "hybrid", params2,
                                         train_x=train_x, max_bucket=32,
                                         device="cpu")
    recycled = ServingRoster(member=np.ones(N, bool),
                             generation=np.asarray([0, 0, 1, 0]),
                             cluster=np.asarray([0, 1, 1, 1]))
    event = front.swap(params=params2, centroids=eng2.centroids,
                       roster=recycled)
    assert event["roster_delta"]["recycled"] == [2]
    post = [front.submit(rows[i], 2) for i in range(8, 16)]
    front.drain()
    assert all(t.done for t in pre + post)
    np.testing.assert_allclose([t.score for t in pre], want_old, atol=1e-5)
    np.testing.assert_allclose(
        [t.score for t in post],
        eng2.score(rows[8:16], np.full(8, 2, np.int32)), atol=1e-5)
    assert front.stats()["rows_served"] == 16
    assert eng.roster.cluster.tolist() == [0, 1, 1, 1]


def test_direct_swap_state_roster_reaches_intake():
    from fedmse_tpu_torch.serving import (ContinuousBatcher, ServingRoster,
                                          UnknownGatewayError)
    _, _, _, eng, rows = _serving_setup(roster=ServingRoster.full(N))
    front = ContinuousBatcher(eng, max_batch=16, latency_budget_ms=1e9)
    front.submit(rows[0], 2)
    eng.swap_state(roster=ServingRoster(
        member=np.asarray([True, True, False, True]),
        generation=np.zeros(N, np.int64)))
    with pytest.raises(UnknownGatewayError, match="UNKNOWN_GATEWAY"):
        front.submit(rows[1], 2)
    eng.swap_state(roster=ServingRoster(member=np.ones(N, bool),
                                        generation=np.asarray([0, 0, 1, 0])))
    front.submit(rows[2], 2)
    front.drain()
    assert front.stats()["rows_served"] == 2


def test_roster_swap_warns_on_recycle_without_params(caplog):
    from fedmse_tpu_torch.serving import ServingRoster
    _, _, _, eng, _ = _serving_setup(roster=ServingRoster.full(N))
    recycled = ServingRoster(member=np.ones(N, bool),
                             generation=np.asarray([0, 1, 0, 0]))
    with caplog.at_level("WARNING", logger="fedmse_tpu_torch"):
        info = eng.swap_state(roster=recycled)
    assert info["roster_delta"]["recycled"] == [1]
    assert any("previous tenant" in r.getMessage() for r in caplog.records)
    with pytest.raises(ValueError, match="slots"):
        eng.swap_state(roster=ServingRoster.full(N + 1))
