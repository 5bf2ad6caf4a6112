"""The port's fused round (fedmse_tpu_torch/federation/fused.py) against the
JAX package's fused engine (`fedmse_tpu.federation.RoundEngine(fused=True)`)
and against the port's own per-phase round.

Both packages start from ONE init (the JAX init exported as numpy) with the
vote tie-break off, at width 16 / 8 / 3 on 4 clients:

  * port fused vs JAX fused over 3 rounds: the selections, aggregators,
    verification rows and rejected counters are equal; params agree to
    1e-4 scale-normalized per leaf (summation order compounded over the
    rounds' Adam steps), per-client AUC to 2e-3, and the aggregation
    weights and the winning voter's scores at rtol 1e-4 / atol 1e-6, the
    JAX package's own fused-vs-per-phase tolerance (tests/test_fused.py);
  * on the CPU the port's fused round runs the same ops as its per-phase
    round, so the two are held bit for bit, and so are a chunk of 3
    rounds and 3 single fused rounds (tie-break on as well: one [R, S, N]
    draw per chunk is R draws of [1, S, N]).
"""

import numpy as np
import pytest
import torch

import jax

from fedmse_tpu.config import CompatConfig as JaxCompat
from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu.federation import RoundEngine as JaxEngine
from fedmse_tpu.models import make_model as jax_make_model
from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine, client_states_from_numpy
from fedmse_tpu_torch.federation.fused import OutLayout
from fedmse_tpu_torch.federation.voting import (elect_aggregator,
                                                elect_on_device,
                                                tie_break_jitter)
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(1)

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N = 4
BASE = dict(dim_features=16, hidden_neus=8, latent_dim=3, network_size=N,
            epochs=3)


def _flat(tree):
    return LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)), tree))


def _pair(model_type, update_type, pad_to=None, tie_break=False, **kw):
    """(JAX fused engine, port fused engine) from one init and data."""
    kw = {**BASE, **kw}
    jcfg = JaxConfig(**kw, compat=JaxCompat(vote_tie_break=tie_break))
    tcfg = ExperimentConfig(**kw,
                            compat=CompatConfig(vote_tie_break=tie_break))
    data_kw = dict(n_clients=N, dim=16, n_normal=240, n_abnormal=120, seed=0)
    tclients, jclients = synthetic_clients(**data_kw), jax_synthetic(**data_kw)
    dev_x = np.concatenate([c.dev_raw for c in tclients])[:200].astype(
        np.float32)
    jeng = JaxEngine(jax_make_model(model_type, *DIMS, jcfg.shrink_lambda),
                     jcfg, jax_stack(jclients, dev_x, 12,
                                     pad_clients_to=pad_to),
                     n_real=N, rngs=JaxRngs(run=0), model_type=model_type,
                     update_type=update_type, fused=True)
    init = client_states_from_numpy(
        jax.tree.map(np.array, jeng.states), LAYOUT, device="cpu")
    teng = port_engine(model_type, update_type, tcfg, tclients, dev_x, init,
                       fused=True, pad_to=pad_to)
    return jeng, teng


def port_engine(model_type, update_type, cfg, clients, dev_x, init, fused,
                pad_to=None):
    return RoundEngine(
        make_model(model_type, *DIMS, cfg.shrink_lambda, device="cpu"), cfg,
        stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                      device="cpu"),
        n_real=N, rngs=ExperimentRngs(run=0), model_type=model_type,
        update_type=update_type, states=init, fused=fused)


def _port_twins(model_type="hybrid", update_type="mse_avg", pad_to=None,
                tie_break=False, **kw):
    """Two port engines from one init: (per-phase, fused)."""
    cfg = ExperimentConfig(**{**BASE, **kw},
                           compat=CompatConfig(vote_tie_break=tie_break))
    clients = synthetic_clients(n_clients=N, dim=16, n_normal=240,
                                n_abnormal=120, seed=1)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    first = port_engine(model_type, update_type, cfg, clients, dev_x, None,
                        fused=False, pad_to=pad_to)
    init = first.states.clone()
    return (port_engine(model_type, update_type, cfg, clients, dev_x, init,
                        fused=False, pad_to=pad_to),
            port_engine(model_type, update_type, cfg, clients, dev_x, init,
                        fused=True, pad_to=pad_to))


def _assert_same_round(got, want):
    """Two RoundResults equal bit for bit (NaN where NaN)."""
    assert got.selected == want.selected
    assert got.aggregator == want.aggregator
    assert got.verification_results == want.verification_results
    for field in ("client_metrics", "mse_scores", "agg_weights", "tracking",
                  "min_valid", "metrics_full"):
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def _assert_same_states(a, b):
    for name in ("params", "prev_global", "hist_params", "hist_perf",
                 "hist_seen", "rejected", "waived"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(x, y)


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
@pytest.mark.parametrize("update_type", ["avg", "fedprox", "mse_avg"])
def test_fused_round_matches_jax_fused(model_type, update_type):
    jeng, teng = _pair(model_type, update_type)
    for r in range(3):
        want, got = jeng.run_round(r), teng.run_round(r)
        assert got.selected == want.selected
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        np.testing.assert_array_equal(teng.states.rejected.numpy(),
                                      np.asarray(jeng.states.rejected))
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        if want.aggregator is not None:
            np.testing.assert_allclose(got.agg_weights, want.agg_weights,
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got.mse_scores, want.mse_scores,
                                       rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got.tracking, want.tracking, rtol=1e-4,
                                   atol=1e-6)
    want_p = _flat(jeng.states.params)
    for sl in LAYOUT.slices():
        err = (teng.states.params[:, sl] - want_p[:, sl]).abs().max()
        assert float(err) <= 1e-4 * float(want_p[:, sl].abs().max())
    np.testing.assert_array_equal(teng.host.aggregation_count,
                                  jeng.host.aggregation_count)
    np.testing.assert_array_equal(teng.host.votes_received,
                                  jeng.host.votes_received)


@pytest.mark.parametrize("tie_break", [False, True])
def test_run_rounds_is_three_fused_rounds_bitwise(tie_break):
    """A chunk of 3 rounds (one upload, one harvest) == 3 single fused
    rounds, bit for bit; the device quota carried through the chunk ==
    the host's counters at its end."""
    _, a = _port_twins(tie_break=tie_break)
    _, b = _port_twins(tie_break=tie_break)
    chunk = a.run_rounds(0, 3)
    single = [b.run_round_fused(r) for r in range(3)]
    for got, want in zip(chunk, single):
        _assert_same_round(got, want)
    _assert_same_states(a.states, b.states)
    np.testing.assert_array_equal(a.host.aggregation_count,
                                  b.host.aggregation_count)
    np.testing.assert_array_equal(
        a.fused_round().agg_count.numpy()[:N], a.host.aggregation_count)


@pytest.mark.parametrize("model_type,update_type,kw", [
    ("hybrid", "mse_avg", {}), ("autoencoder", "fedprox", {}),
    ("hybrid", "avg", {"hardened_verification": True}),
    ("autoencoder", "mse_avg", {"compact_cohort": False}),
    ("hybrid", "fedprox", {"metric": "classification"}),
    ("hybrid", "mse_avg", {"verification_method": "dev"})])
def test_fused_round_is_the_per_phase_round_bitwise(model_type, update_type,
                                                    kw):
    per, fus = _port_twins(model_type, update_type, **kw)
    for r in range(3):
        _assert_same_round(fus.run_round(r), per.run_round(r))
        _assert_same_states(fus.states, per.states)
    np.testing.assert_array_equal(fus.host.aggregation_count,
                                  per.host.aggregation_count)


def test_speculative_epoch_after_an_early_stop_changes_nothing():
    """The host enqueues epoch e + 1 before it reads epoch e's flag, so a
    round that stops early runs one more epoch with every client inactive;
    that epoch changes nothing: the rounds are the per-phase rounds' bits.
    The host reads one flag per epoch but the first."""
    per, fus = _port_twins(epochs=6, lr_rate=0.01)
    for r in range(3):
        _assert_same_round(fus.run_round(r), per.run_round(r))
    _assert_same_states(fus.states, per.states)
    f = fus.fused_round()
    assert min(f.epochs_run) < 6  # early stops happened
    assert f.host_reads == sum(min(e, 5) for e in f.epochs_run)


# how each election case draws its scores, draws and quota (see below)
ELECTIONS = ("uniform", "ties", "nan", "all_nan", "quota", "no_tie_break")


@pytest.mark.parametrize("case", ELECTIONS)
def test_elect_on_device_is_the_host_election(case):
    """voting.elect_on_device against the host's first-voter-wins
    (voting.elect_aggregator, held to the JAX package in
    test_torch_federation.py) fed the same per-voter tie-break: the host's
    i-th score call returns tie_break_jitter(base, draws[i]). The winner
    and the winning voter's scores are the same bits, with ties (equal
    base scores and draws), NaN scores and candidates at or over the
    quota; a cohort with nobody under it has no aggregator (-1, None)."""
    rng = np.random.default_rng(ELECTIONS.index(case))
    for _ in range(200):
        n = int(rng.integers(2, 9))
        s = int(rng.integers(1, n + 1))
        sel = rng.permutation(n)[:s]
        base = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), n)
        if case == "uniform":
            base = rng.random(n, dtype=np.float32)
        if case == "nan":
            base[rng.random(n) < 0.3] = np.nan
        if case == "all_nan":
            base[:] = np.nan
            base[rng.integers(0, n)] = 1.0 if rng.random() < 0.5 else np.nan
        draws = (rng.random((s, n), dtype=np.float32) if case == "uniform"
                 else rng.choice(np.float32([0.25, 0.5, 0.75]), (s, n)))
        quota = rng.integers(0, 3 if case != "quota" else 5, n)
        u = None if case == "no_tie_break" else torch.from_numpy(draws)
        calls = iter(range(s))

        def score_fn():
            i = next(calls)
            b = torch.from_numpy(base)
            return (b if u is None else tie_break_jitter(b, u[i])).numpy()

        want, want_scores = elect_aggregator(
            [int(i) for i in sel], score_fn, quota.copy(),
            np.zeros(n, np.int64), max_threshold=3)
        mask = np.zeros(n, np.float32)
        mask[sel] = 1.0
        got, got_scores = elect_on_device(
            torch.from_numpy(base), u, torch.from_numpy(sel),
            torch.from_numpy(mask), torch.from_numpy(quota.astype(np.int32)),
            max_threshold=3)
        assert int(got) == (-1 if want is None else want), (base, sel, quota)
        if want is None:
            assert not got_scores.any()
        else:
            np.testing.assert_array_equal(got_scores.numpy(), want_scores)



def _elect_on_sheet(base, draws, sel, sel_mask, agg_count, max_threshold,
                    voters=None, cluster_in=None, vote_ok=None, adv=None,
                    lie_votes=False):
    """The election over the full [S, N] candidate sheet, every voter's
    pick formed (the formulation elect_on_device replaced): the
    reference its O(S + N) form is held to."""
    s, n = sel.shape[0], base.shape[0]
    ids = torch.arange(n)
    scores = (base.expand(s, n) if draws is None
              else tie_break_jitter(base, draws))
    sel_pos = torch.full((n,), s, dtype=torch.int64).index_copy(
        0, sel, torch.arange(s))
    cand = ((sel_mask > 0) & (agg_count < max_threshold))[None, :] \
        & (ids[None, :] != sel[:, None])
    if cluster_in is not None:
        cand = cand & (cluster_in[None, :]
                       == cluster_in.index_select(0, sel)[:, None])
    if vote_ok is not None:
        cand = cand & (vote_ok > 0)[None, :]
    found = cand.any(dim=1)
    if voters is not None:
        found = found & (voters.index_select(0, sel) > 0)
    if vote_ok is not None:
        found = found & (vote_ok.index_select(0, sel) > 0)
    masked = torch.where(cand & ~torch.isnan(scores), scores,
                         torch.full_like(scores, float("inf")))
    tie = cand & (masked == masked.min(dim=1, keepdim=True).values)
    pick = torch.where(tie, sel_pos[None, :], s + 1).argmin(dim=1)
    if lie_votes and adv is not None:
        acc = cand & (adv > 0)[None, :]
        acc_pick = torch.where(acc, sel_pos[None, :], s + 1).argmin(dim=1)
        lie = (adv.index_select(0, sel) > 0) & acc.any(dim=1)
        pick = torch.where(lie, acc_pick, pick)
    first = found.to(torch.int32).argmax().view(1)
    won = found.any()
    return (torch.where(won, pick.index_select(0, first)[0], -1),
            torch.where(won, scores.index_select(0, first)[0],
                        torch.zeros_like(base)))


def _election_case(rng, n, s, hooks):
    sel = torch.from_numpy(rng.permutation(n)[:s])
    base = torch.from_numpy(rng.choice(np.float32([0.5, 1.0, np.nan]), n))
    mask = torch.zeros(n)
    mask[sel] = 1.0
    kw = dict(base=base, sel=sel, sel_mask=mask,
              agg_count=torch.from_numpy(rng.integers(0, 4, n).astype(
                  np.int32)), max_threshold=3,
              draws=(torch.from_numpy(rng.choice(
                  np.float32([0.25, 0.5]), (s, n))) if "draws" in hooks
                  else None))
    if "voters" in hooks:
        kw["voters"] = torch.from_numpy((rng.random(n) < 0.7).astype(
            np.float32))
    if "cluster" in hooks:
        kw["cluster_in"] = torch.from_numpy(rng.integers(0, 3, n))
    if "red" in hooks:
        kw["vote_ok"] = torch.from_numpy((rng.random(n) < 0.8).astype(
            np.float32))
        kw["adv"] = torch.from_numpy((rng.random(n) < 0.4).astype(
            np.float32))
        kw["lie_votes"] = True
    return kw


@pytest.mark.parametrize("hooks", [(), ("draws",), ("draws", "voters"),
                                   ("cluster",), ("draws", "cluster", "red"),
                                   ("voters", "cluster", "red")],
                         ids=lambda h: "+".join(h) or "plain")
def test_elect_on_device_is_the_sheet_election(hooks):
    """The election without its [S, N] candidate sheet is the sheet's
    election, bit for bit: the same aggregator (-1 included) and the
    winning voter's scores, under the quota, NaN scores, ties, the fault
    hooks' voters, clusters and the red team's gate and lying votes."""
    rng = np.random.default_rng(len(hooks))
    for _ in range(300):
        n = int(rng.integers(2, 12))
        kw = _election_case(rng, n, int(rng.integers(1, n + 1)), hooks)
        want = _elect_on_sheet(**kw)
        got = elect_on_device(**kw)
        assert int(got[0]) == int(want[0]), kw
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_elect_on_device_forms_no_cohort_by_fleet_tensor():
    """At full participation (S = N) the election's largest tensor is O(N):
    a [S, N] sheet would be 40 GB at 100k gateways. Every op's output is
    counted under a dispatch mode; only the tie-break draws [S, N], an
    input, are that large."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    n = 3000
    for hooks in ((), ("voters", "cluster", "red")):
        kw = _election_case(np.random.default_rng(0), n, n, hooks)
        with Largest():
            agg, _ = elect_on_device(**kw)
        assert Largest.numel <= 4 * n, (hooks, Largest.numel)
        assert int(agg) == int(_elect_on_sheet(**kw)[0])

def test_cohort_of_one_has_no_aggregator():
    """One selected client: no voter has a candidate, so no aggregator
    (-1 on the device -> None); the states pass through aggregation and
    verification, as on the per-phase path and in the JAX fused engine."""
    jeng, teng = _pair("hybrid", "mse_avg", num_participants=0.25)
    per, fus = _port_twins(num_participants=0.25)
    for r in range(2):
        want, got = jeng.run_round(r), teng.run_round(r)
        assert len(got.selected) == 1 and got.selected == want.selected
        assert got.aggregator is None and want.aggregator is None
        assert got.mse_scores is None and got.agg_weights is None
        assert got.verification_results == []
        _assert_same_round(fus.run_round(r), per.run_round(r))
        _assert_same_states(fus.states, per.states)
    assert teng.host.aggregation_count.sum() == 0


def test_quota_exhaustion_has_no_aggregator():
    """Every client at the aggregation quota: no aggregator; the merged
    model is computed on the device but not kept (the states equal the
    per-phase path's, which never aggregates), weights and scores zero on
    the device and None in the RoundResult."""
    jeng, teng = _pair("hybrid", "mse_avg")
    per, fus = _port_twins()
    for eng in (jeng, teng, per, fus):
        eng.host.aggregation_count[:] = eng.cfg.max_aggregation_threshold
    want, got = jeng.run_round(0), teng.run_round(0)
    assert want.aggregator is None and got.aggregator is None
    assert got.mse_scores is None and got.verification_results == []
    np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                               atol=2e-3)
    _assert_same_round(fus.run_round(0), per.run_round(0))
    _assert_same_states(fus.states, per.states)
    f = fus.fused_round()
    row = f.out.unpack(f.out_stack[0].numpy())
    assert row.aggregator == -1
    assert not row.weights.any() and not row.scores.any()


def test_padded_clients():
    """A federation padded to 8 clients: metrics of the 4 real ones, the
    padding never selected, voted for or weighted; the port's fused round
    against the JAX fused round and its own per-phase round."""
    jeng, teng = _pair("hybrid", "mse_avg", pad_to=8)
    per, fus = _port_twins(pad_to=8)
    for r in range(2):
        want, got = jeng.run_round(r), teng.run_round(r)
        assert got.client_metrics.shape == (N,)
        assert np.isfinite(got.client_metrics).all()
        assert got.aggregator == want.aggregator
        assert got.aggregator in got.selected
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        assert not got.agg_weights[N:].any()
        _assert_same_round(fus.run_round(r), per.run_round(r))
        _assert_same_states(fus.states, per.states)


def test_knn_scored_fused_round():
    """score_kind='knn' inside the fused round: the banks' priorities are
    drawn once onto the device and the round matches the per-phase one
    bit for bit; against the JAX fused round the AUC agrees to 2e-3 (a
    bank as large as every client's train rows holds all of them, so the
    two packages' different draws cannot matter)."""
    kw = dict(score_kind="knn", knn_bank_size=128, knn_k=3)
    jeng, teng = _pair("hybrid", "mse_avg", **kw)
    per, fus = _port_twins(**kw)
    assert fus.fused_round().priorities is not None
    for r in range(2):
        want, got = jeng.run_round(r), teng.run_round(r)
        assert got.aggregator == want.aggregator
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=2e-3)
        _assert_same_round(fus.run_round(r), per.run_round(r))


def test_rewind_restores_into_the_round_buffers():
    """A snapshot restored by reassigning engine.states (the driver's
    rewind) is copied into the round's own buffers: replaying the round
    gives the same bits; profile=True runs the per-phase path."""
    per, fus = _port_twins()
    fus.run_round(0)
    snap, host = fus.states.clone(), fus.host.copy()
    first = fus.run_round(1, selected=[0, 1])
    buffers = fus.states
    fus.states, fus.host = snap, host
    _assert_same_round(fus.run_round(1, selected=[0, 1]), first)
    assert fus.states is buffers
    fus.profile = True
    before = fus.fused_round().host_reads
    fus.run_round(2)
    assert fus.fused_round().host_reads == before


def test_out_layout_round_trips():
    layout = OutLayout(3, (3,), 2)
    vals = dict(aggregator=torch.tensor(2), metrics=torch.rand(3, 3),
                scores=torch.rand(3), weights=torch.rand(3),
                rejected=torch.tensor([0, 4, 1], dtype=torch.int32),
                min_valid=torch.rand(3), tracking=torch.rand(3, 2, 3))
    row = layout.pack(**vals)
    assert row.shape == (layout.width,) == (1 + 9 + 12 + 18,)
    out = layout.unpack(row.numpy())
    assert out.aggregator == 2 and out.rejected.tolist() == [0, 4, 1]
    np.testing.assert_array_equal(out.metrics, vals["metrics"].numpy())
    np.testing.assert_array_equal(out.tracking, vals["tracking"].numpy())


def test_fused_engine_refuses_the_time_metric():
    cfg = ExperimentConfig(**BASE, metric="time")
    clients = synthetic_clients(n_clients=N, dim=16, n_normal=60,
                                n_abnormal=20, seed=1)
    with pytest.raises(ValueError, match="time"):
        RoundEngine(make_model("hybrid", *DIMS, device="cpu"), cfg,
                    stack_clients(clients, np.zeros((4, 16), np.float32), 12,
                                  device="cpu"),
                    n_real=N, rngs=ExperimentRngs(run=0),
                    model_type="hybrid", update_type="avg", fused=True)
