"""The keyed vote tie-break (fedmse_tpu_torch/utils/seeding.py
`keyed_uniform_row`, federation/voting.py `KeyedDraws`) and the tier's
size rule (federation/voting.py `TIE_BREAK_SHEET_BYTES`) on the CPU, at
width 16 / 8 / 3:

  * the keyed row in torch is its numpy uint64 twin bit for bit, over
    ids up to 2^33 and pad ids (0.5), for the vote's and the
    re-election's keys; a voter's row is its row of the [S, N] sheet;
  * the election given the keyed source is the election given the full
    [S, N] sheet of the same hash, bit for bit, with and without the
    fault hooks' voters, clusters and the red team's gate and lies; it
    forms nothing of S x N;
  * above the rule (the constant lowered): the tier holds no S x C
    tensor, in its plans or in its round, for the vote or the chaos
    re-election; the keyed tier is the sheet tier fed the keyed sheet,
    bit for bit; padding 4 clients to 8 elects what 4 elect; the run's
    generator draws no tie-break;
  * below the rule the tier's draws are the generator's [S, S] sheet in
    the selected lanes, pinned;
  * both port drivers' --podscale run the JAX drivers' CompatConfig (the
    tie-break on), and their small tiers run through the keyed path.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import churn_sweep_torch
import cluster_sweep_torch
from fedmse_tpu_torch.chaos import ChaosSpec
from fedmse_tpu_torch.cluster import ClusterSpec
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import tiered, voting
from fedmse_tpu_torch.federation.elastic import ElasticSpec
from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
from fedmse_tpu_torch.federation.voting import KeyedDraws, elect_on_device
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import (ExperimentRngs, key_words,
                                            keyed_uniform_row,
                                            keyed_uniform_row_np)
from tests.test_torch_fused import _elect_on_sheet, _election_case
from tests.torch_fault_common import assert_same_states

torch.set_num_threads(1)

DIMS = (16, 8, 3)
N, PAD = 4, 8
KEYS = {"vote run 0": ExperimentRngs(run=0).vote_key(),
        "vote run 3": ExperimentRngs(run=3).vote_key(),
        "reelect run 1": ExperimentRngs(run=1).reelect_key(),
        "wide seed": (2 ** 40 + 17, 0x564F5445)}


def _key(key):
    return torch.tensor(key_words(key), dtype=torch.int64)


# ------------------------------------------------------ the keyed row ----

@pytest.mark.parametrize("name", sorted(KEYS))
def test_keyed_row_is_its_numpy_twin(name):
    key = KEYS[name]
    ids = np.concatenate([np.arange(-3, 40), [2 ** 31 - 1, 2 ** 31,
                                              2 ** 31 + 5, 2 ** 32 - 1,
                                              2 ** 32, 2 ** 33 + 7],
                          np.random.default_rng(0).integers(
                              0, 2 ** 31, 200)]).astype(np.int64)
    for t in (0, 1, 9, 2 ** 31 - 1):
        for v in (0, 1, 5, 4095):
            got = keyed_uniform_row(_key(key), torch.tensor(t),
                                    torch.tensor([v]), torch.from_numpy(ids))
            want = keyed_uniform_row_np(key, t, v, ids)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            assert (got[ids < 0] == 0.5).all()
            real = got[ids >= 0]
            assert ((real >= 0) & (real < 1)).all()
    # a voter's row is its row of the [S, N] sheet
    sheet = keyed_uniform_row(_key(key), torch.tensor(2),
                              torch.arange(6)[:, None], torch.from_numpy(ids))
    np.testing.assert_array_equal(
        sheet.numpy(), keyed_uniform_row_np(key, 2, np.arange(6)[:, None],
                                            ids))
    for v in range(6):
        src = KeyedDraws(_key(key), torch.tensor(2), torch.from_numpy(ids))
        assert torch.equal(src.rows(torch.tensor([v]))[0], sheet[v])


def test_keyed_rows_differ_by_round_voter_client_and_stream():
    """Every input moves the row, and a row looks uniform: 100k lanes'
    mean and spread within 1% of U(0, 1)'s, and nearly all distinct."""
    ids = torch.arange(100_000)
    key = _key(KEYS["vote run 0"])
    base = keyed_uniform_row(key, torch.tensor(3), torch.tensor([2]), ids)
    assert abs(base.mean().item() - 0.5) < 0.005
    assert abs(base.std().item() - 12 ** -0.5) < 0.003
    assert torch.unique(base).numel() > 99_000
    for other in (keyed_uniform_row(key, torch.tensor(4), torch.tensor([2]),
                                    ids),
                  keyed_uniform_row(key, torch.tensor(3), torch.tensor([3]),
                                    ids),
                  keyed_uniform_row(key, torch.tensor(3), torch.tensor([2]),
                                    ids + 1),
                  keyed_uniform_row(_key(KEYS["reelect run 1"]),
                                    torch.tensor(3), torch.tensor([2]), ids)):
        assert (other != base).float().mean() > 0.99


def test_keyed_row_consumes_no_stream():
    rngs = ExperimentRngs(run=0)
    before = rngs.state_dict()
    a = keyed_uniform_row(_key(rngs.vote_key()), torch.tensor(1),
                          torch.tensor([0]), torch.arange(50))
    b = keyed_uniform_row(_key(rngs.vote_key()), torch.tensor(1),
                          torch.tensor([0]), torch.arange(50))
    assert torch.equal(a, b) and rngs.state_dict() == before
    assert rngs.reelect_key()[:2] == rngs.chaos_key()


# ------------------------------------------------------- the election ----

@pytest.mark.parametrize("hooks", [(), ("voters",), ("cluster",),
                                   ("voters", "cluster", "red")],
                         ids=lambda h: "+".join(h) or "plain")
def test_keyed_election_is_the_keyed_sheet_election(hooks):
    """elect_on_device given the keyed source against elect_on_device and
    the sheet election given the full [S, N] sheet of the same hash: the
    same aggregator (-1 included) and the winning voter's scores, bit for
    bit; pad lanes (-1 ids) jitter by a factor of 1."""
    rng = np.random.default_rng(7 + len(hooks))
    key = _key(KEYS["vote run 0"])
    for trial in range(200):
        n = int(rng.integers(2, 14))
        kw = _election_case(rng, n, int(rng.integers(1, n + 1)), hooks)
        ids = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int64))
        ids[torch.from_numpy(rng.random(n) < 0.2)] = -1
        t = torch.tensor(int(rng.integers(0, 1000)))
        s = kw["sel"].shape[0]
        src = KeyedDraws(key, t, ids)
        sheet = src.rows(torch.arange(s))
        got = elect_on_device(**{**kw, "draws": src})
        want = elect_on_device(**{**kw, "draws": sheet})
        ref = _elect_on_sheet(**{**kw, "draws": sheet})
        for other in (want, ref):
            assert int(got[0]) == int(other[0]), (trial, kw)
            np.testing.assert_array_equal(got[1].numpy(), other[1].numpy())
        if int(got[0]) >= 0:  # a pad lane's factor is exactly 1
            pads = ids < 0
            np.testing.assert_array_equal(got[1][pads].numpy(),
                                          kw["base"][pads].numpy())


def test_keyed_election_forms_no_cohort_by_fleet_tensor():
    """At S = N = 3000 the keyed election's largest tensor is O(N): the
    source holds no [S, N] draws, and only the winning voter's row is
    computed."""
    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor):
                    Largest.numel = max(Largest.numel, x.numel())
            return out

    n = 3000
    for hooks in ((), ("voters", "cluster", "red")):
        kw = _election_case(np.random.default_rng(0), n, n, hooks)
        src = KeyedDraws(_key(KEYS["vote run 0"]), torch.tensor(5),
                         torch.arange(n))
        with Largest():
            agg, _ = elect_on_device(**{**kw, "draws": src})
        assert Largest.numel <= 4 * n, (hooks, Largest.numel)
        sheet = src.rows(torch.arange(n))
        assert int(agg) == int(_elect_on_sheet(**{**kw, "draws": sheet})[0])


# ------------------------------------------------ the tier's size rule ----

def _cfg(**kw):
    return ExperimentConfig(**{
        "dim_features": 16, "hidden_neus": 8, "latent_dim": 3,
        "network_size": N, "epochs": 2, "num_rounds": 3,
        "compat": CompatConfig(vote_tie_break=True), **kw})


def _data(pad_to=None, n=N):
    clients = synthetic_clients(n_clients=n, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         device="cpu")


def _tier(cfg, data=None, n=N, cls=TieredRoundEngine, **kw):
    return cls(make_model("hybrid", *DIMS, 5.0, device="cpu"), cfg,
               _data(n=n) if data is None else data, n_real=n,
               rngs=ExperimentRngs(run=0), model_type="hybrid",
               update_type="mse_avg", device="cpu", **kw)


def _run(engine, rounds):
    out = []
    engine.run_rounds(0, rounds, lambda r, s: out.append(r) or False)
    return out


def _same_rounds(got, want):
    for a, b in zip(got, want, strict=True):
        for f in ("selected", "aggregator", "verification_results",
                  "effective", "crashed_aggregator", "members"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("client_metrics", "mse_scores", "agg_weights", "tracking",
                  "min_valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


class SheetTier(TieredRoundEngine):
    """The tier below its rule fed the KEYED hash as its [S, C] sheets:
    the vote's rows and the chaos re-election's, what the keyed round
    computes one row at a time."""

    def _plan(self, round_index, selected=None):
        plan = super()._plan(round_index, selected)
        if plan.draws is not None:
            plan.draws = keyed_uniform_row(
                _key(self.rngs.vote_key()), torch.tensor(round_index),
                torch.arange(len(plan.selected))[:, None],
                torch.from_numpy(plan.ids))
        return plan

    def _reelect_columns(self, round_index, rows, voters):
        ids = np.where(self._plan_ids >= 0, rows, -1)
        return keyed_uniform_row_np(self.rngs.reelect_key(), round_index,
                                    np.arange(voters)[:, None], ids)

    def _mask_kwargs(self, plan):
        self._plan_ids = plan.ids
        return super()._mask_kwargs(plan)


HOOKS = {"clean": {}, "partial": {"num_participants": 0.5},
         "chaos": {"chaos": ChaosSpec(dropout_p=0.3, crash_p=0.9,
                                      broadcast_loss_p=0.2)},
         "elastic+cluster": {"elastic": ElasticSpec(leave_p=0.3, join_p=0.6),
                             "cluster": ClusterSpec(k=2, refit_every=2)}}


def _hooked(name, n=6):
    kw = dict(HOOKS[name])
    cfg = _cfg(network_size=n, num_rounds=4,
               num_participants=kw.pop("num_participants", 1.0))
    return cfg, kw


@pytest.mark.parametrize("name", sorted(HOOKS))
def test_keyed_tier_is_the_tier_fed_the_keyed_sheet(name, monkeypatch):
    """Above the rule (lowered to 0) the tier's rounds, from the same
    init, are the rounds of the tier below it fed the keyed hash's full
    [S, C] sheets (the vote's and the chaos re-election's), bit for bit:
    results, states and the quota."""
    cfg, kw = _hooked(name)
    want_eng = _tier(cfg, n=6, cls=SheetTier, **kw)
    assert not want_eng.keyed_tie_break
    want = _run(want_eng, 4)
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    got_eng = _tier(cfg, n=6, **kw)
    assert got_eng.keyed_tie_break
    got = _run(got_eng, 4)
    _same_rounds(got, want)
    assert_same_states(got_eng.store.host, want_eng.store.host)
    np.testing.assert_array_equal(got_eng.host.aggregation_count,
                                  want_eng.host.aggregation_count)
    if name == "chaos":
        assert any(r.crashed_aggregator is not None for r in got)


class _Shapes(TorchDispatchMode):
    """Every op output's shape, and every tensor the round holds."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                self.shapes.add(tuple(x.shape))
        return out


def _held_shapes(round_):
    held = set()
    for v in vars(round_).values():
        for x in (v.values() if isinstance(v, dict) else (v,)):
            if isinstance(x, torch.Tensor):
                held.add(tuple(x.shape))
    return held


@pytest.mark.parametrize("name", ["clean", "chaos"])
def test_above_the_rule_the_tier_holds_no_cohort_sheet(name, monkeypatch):
    """S = C = 6 (a [6, 6] tensor is the sheet's shape alone at this
    width): below the rule the plan, the round's buffers and its ops hold
    [S, C] draws; above it none exists, on the host or the device, for
    the vote or the chaos re-election, and the run's generator draws no
    tie-break (its state is the init's)."""
    cfg, kw = _hooked(name)
    sheet = (6, 6)
    for keyed in (False, True):
        if keyed:
            monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
        eng = _tier(cfg, n=6, **kw)
        after_init = eng.rngs.generator.get_state()
        plans = []
        plan = eng._plan
        eng._plan = lambda *a, **k: plans.append(plan(*a, **k)) or plans[-1]
        with _Shapes() as seen:
            _run(eng, 2)
        f = eng._round
        held = _held_shapes(f) | {tuple(p.draws.shape) for p in plans
                                  if p.draws is not None}
        holds = any(s[-2:] == sheet for s in held | seen.shapes)
        assert holds is not keyed, (keyed, sorted(held))
        assert (f.u is None) is keyed
        assert ("reelect_draws" in f.input_names) is (
            name == "chaos" and not keyed)
        assert all((p.draws is None) is keyed for p in plans)
        assert torch.equal(eng.rngs.generator.get_state(),
                           after_init) is keyed


def test_keyed_tier_padded_four_to_eight_elects_what_four_elect(monkeypatch):
    """Above the rule, 4 clients padded to 8 on the client axis: the same
    selections, elections, verification rows, results and real states
    bit for bit (the keyed row reads absolute ids, not the padded
    width)."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    for participants in (1.0, 0.5):
        cfg = _cfg(num_participants=participants)
        a, b = _tier(cfg), _tier(cfg, data=_data(pad_to=PAD))
        assert a.keyed_tie_break and b.keyed_tie_break
        _same_rounds(_run(b, 3), _run(a, 3))
        assert_same_states(b.store.host, a.store.host)


def test_below_the_rule_the_tier_draws_the_generator_sheet():
    """Below the rule (the default, S = 6 of 6 and 3 of 6) each round's
    draws are torch.rand((1, S, S)) from the run's generator after the
    init, in the selected lanes, 0.5 in a pad lane: the draws of every
    tier run before the rule, pinned to their values."""
    pins = {  # row 0 of rounds 0 and 1, as the tier drew them before
        1.0: [[0.9747698307037354, 0.5308279395103455, 0.9383888244628906,
               0.6229507923126221, 0.023455321788787842, 0.8288586139678955],
              [0.18761438131332397, 0.1735161542892456, 0.4858707785606384,
               0.2943127155303955, 0.7257062792778015, 0.09349656105041504]],
        0.5: [[0.9747698307037354, 0.5308279395103455, 0.9383888244628906],
              [0.3113963007926941, 0.7672639489173889, 0.1636340618133545]]}
    for participants, first in pins.items():
        cfg = _cfg(network_size=6, num_participants=participants)
        eng = _tier(cfg, n=6)
        assert not eng.keyed_tie_break
        gen = torch.Generator()
        gen.set_state(eng.rngs.generator.get_state())
        for r in range(3):
            plan = eng._plan(r)
            s = len(plan.selected)
            want = torch.full((s, eng.cohort), 0.5)
            want[:, torch.from_numpy(plan.ids >= 0)] = torch.rand(
                (1, s, s), generator=gen)[0]
            assert torch.equal(plan.draws, want)
            if r < 2:
                np.testing.assert_array_equal(plan.draws[0].numpy(),
                                              np.float32(first[r]))


def test_the_rule_is_the_selection_sheet_bytes():
    cfg = _cfg()
    assert voting.TIE_BREAK_SHEET_BYTES == 64 << 20
    assert not tiered.keyed_tie_break(cfg, 4096)
    assert tiered.keyed_tie_break(cfg, 4097)
    assert tiered.keyed_tie_break(cfg, 100_000)
    off = dataclasses.replace(cfg, compat=CompatConfig(vote_tie_break=False))
    assert not tiered.keyed_tie_break(off, 100_000)


# ------------------------------------------------------ the drivers ----

class _Stop(Exception):
    pass


def _first_tier_config(monkeypatch, module, fn):
    """The config of the first TieredRoundEngine `fn()` builds."""
    seen = []

    def record(model, cfg, *a, **k):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(module, "TieredRoundEngine", record)
    with pytest.raises(_Stop):
        fn()
    return seen[0]


@pytest.mark.parametrize("driver", ["churn", "cluster"])
def test_port_podscale_config_is_the_jax_drivers(driver, monkeypatch):
    """Both port drivers' --podscale CompatConfig is the JAX driver's:
    the vote tie-break on (its default), shared_last_client_val off."""
    import sys
    import fedmse_tpu.federation as jax_federation
    import fedmse_tpu_torch.federation as port_federation
    jax_mod = __import__(f"{driver}_sweep")
    port_mod = {"churn": churn_sweep_torch,
                "cluster": cluster_sweep_torch}[driver]
    monkeypatch.setattr(sys, "argv", [f"{driver}_sweep.py", "--podscale",
                                      "--clients", "8"])
    jcfg = _first_tier_config(monkeypatch, jax_federation,
                              jax_mod.podscale_main)
    tcfg = _first_tier_config(
        monkeypatch, port_federation,
        lambda: port_mod.main(["--podscale", "--device", "cpu",
                               "--clients", "8", "--out", "/dev/null"]))
    assert tcfg.compat.vote_tie_break is True
    for f in dataclasses.fields(tcfg.compat):
        assert getattr(tcfg.compat, f.name) == getattr(jcfg.compat, f.name), \
            f.name
    assert (tcfg.num_participants, tcfg.state_layout, tcfg.host_sharded) \
        == (jcfg.num_participants, jcfg.state_layout, jcfg.host_sharded)


def _count_keyed(monkeypatch):
    """Each tier dispatch's (keyed, plan.draws is None), recorded."""
    seen = []
    dispatch = TieredRoundEngine._dispatch

    def spy(self, pf):
        seen.append((self.keyed_tie_break, pf.plan.draws is None,
                     self._round.u is None))
        return dispatch(self, pf)

    monkeypatch.setattr(TieredRoundEngine, "_dispatch", spy)
    return seen


def test_churn_podscale_through_the_keyed_path(tmp_path, monkeypatch):
    """churn_sweep_torch --podscale on a 64-gateway tier with the rule
    lowered: every round keyed (no sheet, no draws), the tie-break on,
    the null-elastic pin and the acceptance block written."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    seen = _count_keyed(monkeypatch)
    out = tmp_path / "pod.json"
    churn_sweep_torch.main(["--podscale", "--device", "cpu", "--clients",
                            "64", "--out", str(out)])
    art = json.loads(out.read_text())
    assert seen and all(s == (True, True, True) for s in seen)
    assert "vote tie-break on (keyed rows" in art["protocol"]
    rows = {r["label"]: r for r in art["rows"]}
    assert rows["null-elastic-100k"]["bit_identical_to_static"] is True
    acc = art["acceptance"]
    assert acc["null_bitwise"] is True
    assert acc["met"] == bool(acc["joiner_bars_met"]
                              and acc["per_slot_ceiling_met"])


def test_cluster_podscale_through_the_keyed_path(tmp_path, monkeypatch):
    """cluster_sweep_torch --podscale on a 64-gateway tier with the rule
    lowered: every round keyed, the K = 1 pin bit for bit, the
    assignment over every gateway and the acceptance block written."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    seen = _count_keyed(monkeypatch)
    out = tmp_path / "pod.json"
    cluster_sweep_torch.main(["--podscale", "--device", "cpu", "--clients",
                              "64", "--out", str(out)])
    art = json.loads(out.read_text())
    assert seen and all(s == (True, True, True) for s in seen)
    assert "vote tie-break on (keyed rows" in art["protocol"]
    rows = {r["label"]: r for r in art["rows"]}
    assert rows["k1-bitwise-pin-100k"]["states_bit_identical"] is True
    assert sum(rows["typed-100k-k4-vs-single"]["cluster_sizes"]) == 64
    acc = art["acceptance"]
    assert acc["met"] == bool(acc["k1_bit_identical"] and acc["purity_met"]
                              and acc["delta_met"])
