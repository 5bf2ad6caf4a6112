"""The port's federation modules (fedmse_tpu_torch/federation) against the
JAX package's, from the same seeded data and the same exported init:
stacked Adam vs optax, the vote scores, the election, aggregation,
verification (both rules) and local training (compact and dense).

Tolerances: Adam 1e-6 relative (elementwise f32, same formula; the
moments 1e-6 of their scale); scores
1e-5; aggregation weights and merged params 1e-6; verification floats
1e-5 with accept bits and counters exactly equal; local training params
1e-4 scale-normalized per leaf after a multi-epoch run (summation order,
compounded over ~90 Adam steps), tracking 1e-5, the early-stop epochs
equal.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.federation.aggregation import make_aggregate_fn as jax_agg_fn
from fedmse_tpu.federation.local_training import \
    make_local_train_all as jax_train_fn
from fedmse_tpu.federation.state import init_client_states as jax_init
from fedmse_tpu.federation.verification import make_verify_fn as jax_verify_fn
from fedmse_tpu.federation.voting import (elect_aggregator as jax_elect,
                                          make_mse_scores_fn as jax_scores_fn)
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation.aggregation import make_aggregate_fn
from fedmse_tpu_torch.federation.local_training import make_local_train_all
from fedmse_tpu_torch.federation.optim import (adam_init, adam_step,
                                               opt_state_from_numpy,
                                               opt_state_to_numpy)
from fedmse_tpu_torch.federation.state import client_states_from_numpy
from fedmse_tpu_torch.federation.verification import make_verify_fn
from fedmse_tpu_torch.federation.voting import (elect_aggregator,
                                                make_mse_scores_fn)
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
T = torch.from_numpy


def _np(tree):
    return jax.tree.map(lambda t: np.array(t), tree)


def _flat(tree):
    """[N, P] torch buffer of a stacked numpy/jax param tree."""
    return LAYOUT.flatten(jax.tree.map(lambda t: T(np.array(t, np.float32)),
                                       tree))


def _models(model_type="hybrid"):
    jm = jax_make_model(model_type, *DIMS, shrink_lambda=5.0)
    tm = make_model(model_type, *DIMS, shrink_lambda=5.0, device="cpu")
    return jm, tm


def _federation(n=4, seed=0):
    kw = dict(n_clients=n, dim=DIMS[0], n_normal=120, n_abnormal=40,
              seed=seed)
    jcl, tcl = jax_synthetic(**kw), synthetic_clients(**kw)
    dev_x = np.concatenate([c.dev_raw for c in tcl])[:60].astype(np.float32)
    return jax_stack(jcl, dev_x, 12), stack_clients(tcl, dev_x, 12,
                                                    device="cpu")


def _states(jm, n, tx, seed=0):
    js = jax_init(jm, tx, jax.random.key(seed), n)
    return js, client_states_from_numpy(_np(js), LAYOUT, device="cpu")


def _leaf_err(got, want):
    """Worst per-leaf scale-normalized error of two [N, P] buffers."""
    return max(float((got[:, sl] - want[:, sl]).abs().max()
                     / max(float(want[:, sl].abs().max()), 1e-30))
               for sl in LAYOUT.slices())


def test_stacked_adam_matches_optax_with_skipped_steps():
    rng = np.random.default_rng(0)
    n = 3
    tx = optax.adam(1e-3)
    params = rng.normal(size=(n, LAYOUT.size)).astype(np.float32)
    jtree = LAYOUT.views(T(params))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), jtree)
    jo = jax.vmap(tx.init)(jp)

    @jax.jit
    def jstep(p, o, g, step):
        upd, o2 = jax.vmap(tx.update)(g, o, p)
        p2 = optax.apply_updates(p, upd)
        sel = lambda a, b: jnp.where(  # noqa: E731
            step.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        return jax.tree.map(sel, p2, p), jax.tree.map(sel, o2, o)

    tp, to = T(params.copy()), adam_init(T(params))
    for k in range(24):
        g = (rng.normal(size=(n, LAYOUT.size)) * 10.0 ** rng.uniform(-3, 1)
             ).astype(np.float32)
        step = rng.random(n) < 0.7  # different per-client counts
        jp, jo = jstep(jp, jo, jax.tree.map(
            lambda t: jnp.asarray(t.numpy()), LAYOUT.views(T(g))),
            jnp.asarray(step))
        tp, to = adam_step(tp, to, T(g), T(step), 1e-3)
    want = _flat(jp)
    np.testing.assert_allclose(tp.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
    theirs = opt_state_from_numpy(_np(jo), LAYOUT, device="cpu")
    np.testing.assert_array_equal(to.count.numpy(), theirs.count.numpy())
    assert len(set(to.count.tolist())) > 1
    # moments: 1e-6 of each buffer's scale (XLA may contract the moment
    # update into an FMA; a near-zero mu then differs by an ulp of the sum)
    for got, want in ((to.mu, theirs.mu), (to.nu, theirs.nu)):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    back = opt_state_to_numpy(to, LAYOUT)
    np.testing.assert_array_equal(back["count"], to.count.numpy())
    np.testing.assert_array_equal(
        back["mu"]["decoder"]["Dense_1"]["bias"],
        LAYOUT.views(to.mu)["decoder"]["Dense_1"]["bias"].numpy())


@pytest.mark.parametrize("restandardize", [True, False])
def test_vote_scores_match_jax(restandardize):
    jdata, tdata = _federation()
    jm, tm = _models()
    js, ts = _states(jm, 4, optax.adam(1e-3))
    vx, vm = jdata.valid_x[1], jdata.valid_m[1]
    want = jax_scores_fn(jm, restandardize=restandardize, tie_break=False)(
        js.params, vx, vm, jax.random.key(0))
    got = make_mse_scores_fn(tm, restandardize=restandardize,
                             tie_break=False)(ts.params, tdata.valid_x[1],
                                              tdata.valid_m[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the tie-break moves every score by at most 0.01%
    tb = make_mse_scores_fn(tm, restandardize=restandardize)(
        ts.params, tdata.valid_x[1], tdata.valid_m[1],
        torch.Generator().manual_seed(0))
    assert torch.all((tb / got - 1).abs() <= 1e-4 + 1e-7)


def test_election_quota_and_single_client():
    scores = np.array([0.5, 0.1, 0.3, 0.2, 0.9])
    winners = []
    for sel, counts in (([0, 1, 2, 3], [0, 3, 0, 1, 0]),
                        ([4, 1], [0, 3, 0, 0, 0]),
                        ([0, 1], [0, 3, 0, 0, 0]),
                        ([2], [0, 0, 0, 0, 0])):
        out = []
        for fn in (jax_elect, elect_aggregator):
            c = np.array(counts)
            v = np.zeros(5, np.int64)
            agg, s = fn(sel, lambda: scores, c, v, 3)
            out.append((agg, v.tolist()))
        assert out[0] == out[1], (sel, out)
        winners.append(out[1][0])
    # 1 is over quota: 3 wins, 4 finds nobody and 1 votes for 4, 0 finds
    # nobody and 1 votes for 0; a cohort of one has no candidate
    assert winners == [3, 4, 0, None]


@pytest.mark.parametrize("update_type", ["avg", "fedprox", "mse_avg"])
@pytest.mark.parametrize("compact", [False, True])
def test_aggregation_matches_jax(update_type, compact):
    jdata, tdata = _federation()
    jm, tm = _models()
    js, ts = _states(jm, 4, optax.adam(1e-3))
    sel = [0, 2, 3]
    mask = np.zeros(4, np.float32)
    mask[sel] = 1.0
    jidx = jnp.asarray(sel, jnp.int32) if compact else None
    tidx = torch.tensor(sel) if compact else None
    jmerged, jw = jax_agg_fn(jm, update_type)(js.params, jnp.asarray(mask),
                                              jdata.dev_x, sel_idx=jidx)
    merged, w = make_aggregate_fn(tm, update_type)(ts.params, T(mask),
                                                   tdata.dev_x, sel_idx=tidx)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    want = _flat(jax.tree.map(lambda t: np.asarray(t)[None], jmerged))[0]
    np.testing.assert_allclose(merged.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _agg_tree_and_flat(kind, jparams, rng):
    mean = jax.tree.map(lambda t: np.asarray(t).mean(axis=0), jparams)
    if kind == "mean":
        tree = mean
    elif kind == "nudge":
        tree = jax.tree.map(lambda t: t + 0.01 * rng.normal(size=t.shape)
                            .astype(np.float32), mean)
    elif kind == "scaled":
        tree = jax.tree.map(lambda t: 4.0 * t, mean)
    else:
        raise ValueError(kind)
    return tree, _flat(jax.tree.map(lambda t: t[None], tree))[0]


@pytest.mark.parametrize("rule", [
    dict(),                                         # the reference rule
    dict(performance_threshold=-1.0),               # reject by performance
    dict(hardened=True),
    dict(hardened=True, verification_threshold=0.5,
         recovery_threshold=-1.0, recovery_budget=2.0),  # waiver + budget
])
@pytest.mark.parametrize("shared", [True, False])
def test_verification_matches_jax(rule, shared):
    jdata, tdata = _federation(n=5)
    jm, tm = _models()
    js, ts = _states(jm, 5, optax.adam(1e-3), seed=3)
    jverify, tverify = jax_verify_fn(jm, **rule), make_verify_fn(tm, **rule)
    client_mask = np.array([1, 1, 1, 1, 0], np.float32)  # one padded slot
    if shared:
        tx_, tm_ = tdata.valid_x[3], tdata.valid_m[3]
        jx = jnp.broadcast_to(jdata.valid_x[3], (5,) + jdata.valid_x[3].shape)
        jmk = jnp.broadcast_to(jdata.valid_m[3], (5,) + jdata.valid_m[3].shape)
    else:
        tx_, tm_, jx, jmk = (tdata.valid_x, tdata.valid_m, jdata.valid_x,
                             jdata.valid_m)
    rng = np.random.default_rng(1)
    seen = {"accept": 0, "reject": 0, "waived": 0.0}
    for step, kind in enumerate(["mean", "nudge", "scaled", "scaled",
                                 "nudge", "mean"]):
        tree, flat = _agg_tree_and_flat(kind, js.params, rng)
        onehot = np.zeros(5, np.float32)
        onehot[step % 4] = 1.0
        jo = jverify(js, tree, jx, jmk, jnp.asarray(onehot),
                     jnp.asarray(client_mask))
        to = tverify(ts, flat, tx_, tm_, T(onehot), T(client_mask))
        np.testing.assert_array_equal(to.accepted.numpy(),
                                      np.asarray(jo.accepted))
        for a, b in ((to.perf_change, jo.perf_change),
                     (to.param_delta, jo.param_delta),
                     (to.states.waived, jo.states.waived),
                     (to.states.hist_perf, jo.states.hist_perf)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_array_equal(to.states.rejected.numpy(),
                                      np.asarray(jo.states.rejected))
        np.testing.assert_array_equal(to.states.hist_seen.numpy(),
                                      np.asarray(jo.states.hist_seen))
        for got, want in ((to.states.params, jo.states.params),
                          (to.states.prev_global, jo.states.prev_global),
                          (to.states.hist_params, jo.states.hist_params)):
            np.testing.assert_allclose(got.numpy(), _flat(want).numpy(),
                                       rtol=1e-6, atol=1e-6)
        attempted = (client_mask > 0) & (onehot == 0)
        acc = to.accepted.numpy()
        seen["accept"] += int((acc & attempted).sum())
        seen["reject"] += int((~acc & attempted).sum())
        seen["waived"] = float(to.states.waived.max())
        js, ts = jo.states, to.states
    assert seen["accept"] > 0 and seen["reject"] > 0, seen
    if rule.get("recovery_budget"):
        assert seen["waived"] > 0, seen


@pytest.mark.parametrize("compact,restore_best,update_type", [
    (True, False, "avg"), (False, False, "avg"), (True, True, "fedprox"),
    (False, True, "fedprox")])
def test_local_training_matches_jax(compact, restore_best, update_type):
    jdata, tdata = _federation()
    jm, tm = _models()
    # a large step, so some clients stop before the epoch budget
    lr, epochs, patience, mu = 0.1, 4, 1, 0.01
    tx = optax.adam(lr)
    js, ts = _states(jm, 4, tx, seed=5)
    fedprox = update_type == "fedprox"
    # prev_global away from params, so the prox term pulls
    jprev = jax.tree.map(lambda t: t * 0.5, js.params)
    tprev = ts.params * 0.5
    sel = [0, 1, 3]
    mask = np.zeros(4, np.float32)
    mask[sel] = 1.0
    jtrain = jax_train_fn(jm, tx, epochs=epochs, patience=patience,
                          fedprox=fedprox, mu=mu, donate=False,
                          restore_best=restore_best)
    want = jtrain(js.params, js.opt_state, jprev, jnp.asarray(mask),
                  jdata.train_xb, jdata.train_mb, jdata.valid_xb,
                  jdata.valid_mb,
                  sel_idx=jnp.asarray(sel, jnp.int32) if compact else None)
    got = make_local_train_all(tm, epochs, patience, fedprox, mu, lr,
                               restore_best=restore_best)(
        ts.params, ts.opt_state, tprev, T(mask), tdata.train_xb,
        tdata.train_mb, tdata.valid_xb, tdata.valid_mb,
        sel_idx=torch.tensor(sel) if compact else None)
    assert _leaf_err(got.params, _flat(want[0])) <= 1e-4
    assert _leaf_err(got.best_params, _flat(want[2])) <= 1e-4
    wtrack = np.asarray(want[4])
    np.testing.assert_array_equal(got.tracking[..., 2].numpy(),
                                  wtrack[..., 2])  # the same epochs ran
    ran = np.nansum(wtrack[..., 2], axis=1)
    assert ran[sel].min() < epochs == ran[sel].max()
    np.testing.assert_allclose(got.tracking.numpy(), wtrack, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.min_valid.numpy(), np.asarray(want[3]),
                               rtol=1e-5)
    theirs = opt_state_from_numpy(_np(want[1]), LAYOUT, device="cpu")
    np.testing.assert_array_equal(got.opt_state.count.numpy(),
                                  theirs.count.numpy())
    # unselected client 2 passes through untouched
    torch.testing.assert_close(got.params[2], ts.params[2], rtol=0, atol=0)
