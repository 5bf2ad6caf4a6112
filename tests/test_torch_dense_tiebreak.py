"""The keyed vote tie-break of the dense, batched, chaos and meshed fused
rounds above the size rule (fedmse_tpu_torch/federation/voting.py
`keyed_tie_break`, `TIE_BREAK_SHEET_BYTES`, lowered here by monkeypatch)
on the CPU, at width 16 / 8 / 3:

  (a) the dense fused round keyed, over two chunks with an early stop's
      rewind (pipelined and serial), is the same round below the rule fed
      the keyed hash's [R, S, N] sheet (keyed_uniform_row_np), bit for
      bit: selections, elections, verification rows, states, the quota;
  (b) above the rule no round holds or forms a tensor whose last two
      axes are the [S, N] sheet's (the shape spy of
      test_torch_tiebreak), for the vote or the chaos re-election, in the
      dense and the batched round, and no generator draws a tie-break;
      below it they do;
  (c) below the rule the dense and batched draws, the chaos re-election's
      and the elections they give are the values pinned on the commit
      before keyed dense rounds existed;
  (d) a batched R = 3 keyed run is each run alone keyed, bit for bit,
      under the fault hooks and through the driver's early stops;
  (e) a keyed run padded from 4 to 8 clients elects what 4 clients
      elect;
  (f) a keyed mesh at W = 2 (tests/torch_mesh_jobs.py `rounds_keyed`) is
      the keyed run on one process: elections, round-1 params within
      1e-6 scaled per leaf;
  (g) a keyed chaos crash re-election is the round fed the keyed
      re-election sheet;
  (h) with both rules lowered the tier at C == N is the dense engine.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_mesh_jobs as jobs
from torch_mesh_common import close, rank_session
from fedmse_tpu_torch.chaos import ChaosSpec
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine, tiered, voting
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.federation.elastic import ElasticSpec
from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
from fedmse_tpu_torch.federation.rounds import lane_ids
from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
from fedmse_tpu_torch.main import (GlobalEarlyStop, run_batched_combination,
                                   run_combination)
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import ExperimentRngs, keyed_uniform_row_np
from tests.test_torch_padding import _same_real_states, _same_round_bits
from tests.torch_fault_common import (DIMS, assert_same_round,
                                      assert_same_states, port_cfg)

torch.set_num_threads(1)

N, PAD, RUNS = 4, 8, 3
CRASH = ChaosSpec(dropout_p=0.1, crash_p=0.8, broadcast_loss_p=0.2)


def _cfg(**kw):
    return port_cfg(tie_break=True, **{"network_size": N, **kw})


def _data(n=N, pad_to=None):
    clients = synthetic_clients(n_clients=n, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         device="cpu")


def _model(cfg):
    return make_model("hybrid", *DIMS, cfg.shrink_lambda, device="cpu")


def _sheet(key, start, k, voters, ids) -> torch.Tensor:
    """The keyed hash of rounds [start, start + k) as the [k, S, N] sheet a
    keyed round computes one row at a time."""
    return torch.from_numpy(np.stack([
        keyed_uniform_row_np(key, start + r, np.arange(voters)[:, None], ids)
        for r in range(k)]))


class SheetEngine(RoundEngine):
    """The dense engine below the rule, whatever its limit, fed the KEYED
    hash as its [R, S, N] vote sheet and its chaos re-election sheet."""

    def _keyed(self, cohort=None):
        return False

    def dispatch_schedule_chunk(self, start_round, n_rounds, agg_count=None,
                                snapshot=False, schedule=None, draws=None,
                                cluster_in=None):
        if schedule is None:
            schedule = [self.select_clients() for _ in range(n_rounds)]
        if draws is None:
            draws = _sheet(self.rngs.vote_key(), start_round, n_rounds,
                           len(schedule[0]),
                           lane_ids(self.n_real, self.n_pad))
        return super().dispatch_schedule_chunk(
            start_round, n_rounds, agg_count, snapshot, schedule, draws,
            cluster_in)

    def _reelect_draws(self, start_round, n_rounds, cohort):
        return _sheet(self.rngs.reelect_key(), start_round, n_rounds, cohort,
                      lane_ids(self.n_real, self.n_pad)).numpy()


def _dense(cfg, data=None, cls=RoundEngine, run=0, **kw):
    data = _data(cfg.network_size) if data is None else data
    return cls(_model(cfg), cfg, data, n_real=cfg.network_size,
               rngs=ExperimentRngs(run=run), model_type="hybrid",
               update_type="mse_avg", fused=True, **kw)


def _batched(cfg, data=None, **kw):
    data = _data(cfg.network_size) if data is None else data
    return BatchedRunEngine(_model(cfg), cfg, data, n_real=cfg.network_size,
                            runs=RUNS, model_type="hybrid",
                            update_type="mse_avg", **kw)


def _batched_rows(engine, k):
    """k rounds of every run in one chunk, absorbed: [run][round]."""
    outs, sched, _ = engine.run_schedule_chunk(0, k, np.ones(RUNS, bool))
    return [[engine.process_round(r, i, sched[i][r], outs, i)
             for i in range(k)] for r in range(RUNS)]


def _same_engines(got, want):
    assert_same_states(got.states, want.states)
    np.testing.assert_array_equal(got.host.aggregation_count,
                                  want.host.aggregation_count)


# ------------------------------------------- (a) the dense round, keyed ----

@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "serial"])
def test_keyed_dense_round_is_the_round_fed_the_keyed_sheet(pipelined,
                                                            monkeypatch):
    """Chunks of 2 over 6 rounds, S = 3 of 4: round 2 stops the run, so
    the second chunk is rewound to its entry and round 2 replayed (and,
    pipelined, the third chunk is dropped). The keyed engine, whose
    replay re-runs the keyed round, against the engine below the rule fed
    the keyed hash's sheets, which replays the recorded sheet: the same
    rounds, states and quota bit for bit, and no generator draw."""
    cfg = _cfg(num_rounds=6, num_participants=0.75, fused_schedule_chunk=2)

    def drive(eng):
        seen = []

        def consume(results, sec):
            for j, r in enumerate(results):
                seen.append(r)
                if r.round_index == 2:
                    return j
            return None
        run_pipelined_schedule(eng, 0, 6, 2, consume, can_rewind=True,
                               pipelined=pipelined)
        return seen

    want_eng = _dense(cfg, cls=SheetEngine)
    want = drive(want_eng)
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    got_eng = _dense(cfg)
    after_init = got_eng.rngs.generator.get_state()
    got = drive(got_eng)
    assert got_eng.keyed_tie_break and not want_eng.keyed_tie_break
    assert [r.round_index for r in got] == [0, 1, 2]
    for a, b in zip(got, want, strict=True):
        assert_same_round(a, b)
    _same_engines(got_eng, want_eng)
    assert torch.equal(got_eng.rngs.generator.get_state(), after_init)
    assert torch.equal(want_eng.rngs.generator.get_state(), after_init)
    f = got_eng.fused_round()
    assert f.u is None and f.u_all is None and f.tie_keys is not None


def test_a_keyed_round_follows_the_engines_streams(monkeypatch):
    """A driver that hands a built engine another run's streams (the paper
    check, the parity probe, the flywheel) gets that run's keyed rounds:
    the round's key buffers are rewritten, and the rounds are a fresh
    engine's of that run, bit for bit."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    cfg = _cfg(num_rounds=2, num_participants=1.0)
    data = _data()
    eng = _dense(cfg, data)
    eng.run_rounds(0, 2)
    eng.rngs = ExperimentRngs(run=1)
    eng.reset_federation()
    got = eng.run_rounds(0, 2)
    fresh = _dense(cfg, data, run=1)
    for a, b in zip(got, fresh.run_rounds(0, 2), strict=True):
        assert_same_round(a, b)
    _same_engines(eng, fresh)
    f, g = eng.fused_round(), fresh.fused_round()
    assert f.tie_keys == g.tie_keys != _dense(cfg, data)._tie_keys()
    for name in ("vote", "reelect"):
        assert torch.equal(f.tie_key[name], g.tie_key[name])


def test_a_keyed_round_takes_no_sheet_and_needs_its_keys(monkeypatch):
    """Above the rule there is no fallback: a sheet handed to a keyed round
    is refused, and a round built without keys refuses to run."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    cfg = _cfg(num_rounds=2)
    eng = _dense(cfg)
    s = eng.cohort_size()
    with pytest.raises(ValueError, match="no draws"):
        eng.run_round_fused(0, selected=list(range(s)),
                            draws=torch.full((s, N), 0.5))
    eng = _dense(cfg)
    eng.fused_round().tie_keys = None
    with pytest.raises(RuntimeError, match="must be keyed"):
        eng.run_rounds(0, 1)
    bat = _batched(cfg)
    bat.fused_round().tie_keys = None
    with pytest.raises(RuntimeError, match="must be keyed"):
        bat.run_schedule_chunk(0, 1, np.ones(RUNS, bool))


def test_the_rule_is_the_sheet_of_the_real_fleet(monkeypatch):
    """voting.keyed_tie_break: 4 x voters x width bytes over 64 MiB, the
    tie-break on; the dense engine reads (S, n_real), so padding does not
    move it; the tier keeps (S, S) through the same function and the same
    limit, so lowering the one constant moves both."""
    cfg = _cfg()
    assert voting.TIE_BREAK_SHEET_BYTES == 64 << 20
    assert not voting.keyed_tie_break(cfg, 4096, 4096)
    assert voting.keyed_tie_break(cfg, 4096, 4097)
    assert voting.keyed_tie_break(cfg, 512, 100_000)
    assert not voting.keyed_tie_break(cfg, 200, 10_000)
    off = port_cfg(tie_break=False)
    assert not voting.keyed_tie_break(off, 100_000, 100_000)
    for n_sel in (4096, 4097):
        assert tiered.keyed_tie_break(cfg, n_sel) == \
            voting.keyed_tie_break(cfg, n_sel, n_sel)
    with monkeypatch.context() as m:
        m.setattr(voting, "TIE_BREAK_SHEET_BYTES", 47)
        assert voting.keyed_tie_break(cfg, 3, 4)
        assert tiered.keyed_tie_break(cfg, 4)
        m.setattr(voting, "TIE_BREAK_SHEET_BYTES", 64)
        assert not voting.keyed_tie_break(cfg, 3, 4)
        assert not tiered.keyed_tie_break(cfg, 4)
    plain, padded = _dense(cfg), _dense(cfg, data=_data(pad_to=PAD))
    assert padded.n_pad == PAD
    assert plain.keyed_tie_break is padded.keyed_tie_break is False


# ------------------------------------------- (b) no sheet above the rule ----

class _Shapes(TorchDispatchMode):
    """Every op output's shape."""

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


@pytest.mark.parametrize("kind", ["dense", "dense+chaos", "batched",
                                  "batched+chaos"])
def test_above_the_rule_no_round_holds_a_sheet(kind, monkeypatch):
    """N = S = 7 (a [7, 7] tensor is the sheet's shape alone at this
    width): below the rule the round's buffers and its ops hold [S, N]
    draws (the chaos re-election's too); above it none exists, and no
    run's generator draws a tie-break (its state is the init's)."""
    n = 7
    cfg = _cfg(network_size=n, num_participants=1.0, num_rounds=2)
    hooks = {"chaos": CRASH} if "chaos" in kind else {}
    for keyed in (False, True):
        if keyed:
            monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
        if kind.startswith("batched"):
            eng = _batched(cfg, **hooks)
            gens = [r.generator for r in eng.rngs]
        else:
            eng = _dense(cfg, **hooks)
            gens = [eng.rngs.generator]
        after_init = [g.get_state() for g in gens]
        with _Shapes() as seen:
            if kind.startswith("batched"):
                _batched_rows(eng, 2)
            else:
                eng.run_rounds(0, 2)
        f = eng.fused_round()
        holds = any(s[-2:] == (n, n)
                    for s in _held_shapes(f) | seen.shapes)
        assert holds is not keyed, (kind, keyed)
        assert eng.keyed_tie_break is keyed
        assert (f.u is None) is keyed and (f.u_all is None) is keyed
        assert ("reelect_draws" in f.input_names) is (
            "chaos" in kind and not keyed)
        assert all(torch.equal(g.get_state(), a)
                   for g, a in zip(gens, after_init)) is keyed


# --------------------------------------------- (c) below the rule, pinned ----

PINS = {  # on the commit before keyed dense rounds, 4 clients, S = 2
    "dense": {
        "draws[0]": [[0.2401217222213745, 0.5244502425193787,
                      0.4180125594139099, 0.2561607360839844],
                     [0.8486670255661011, 0.3387555480003357,
                      0.3570324182510376, 0.1267527937889099]],
        "draws[2]": [[0.05419880151748657, 0.3492830991744995,
                      0.384202778339386, 0.22066056728363037],
                     [0.8514764904975891, 0.682850182056427,
                      0.8886628150939941, 0.1540384292602539]],
        "reelect[1]": [[0.4397251009941101, 0.5548765063285828,
                        0.22942638397216797, 0.2338826060295105],
                       [0.7056491374969482, 0.9986514449119568,
                        0.4842158555984497, 0.8454625606536865]],
        "aggregators": [2, -1, -1],
        "scores[0]": [0.969202995300293, 0.9639891982078552,
                      0.9543288946151733, 0.9581224322319031]},
    "batched": {
        "draws[1][2]": [[0.2523082494735718, 0.8929829597473145,
                         0.7969368696212769, 0.04475510120391846],
                        [0.8960544466972351, 2.7477741241455078e-05,
                         0.021905839443206787, 0.7472675442695618]],
        "reelect[0][1]": [[0.08401906490325928, 0.78610759973526,
                           0.46357738971710205, 0.33085256814956665],
                          [0.19692683219909668, 0.6073560118675232,
                           0.5675483345985413, 0.14315950870513916]],
        "aggregators": [[2, -1, 1], [-1, -1, -1], [-1, -1, 3]],
        "scores[0][0]": [0.969202995300293, 0.9639891982078552,
                         0.9543288946151733, 0.9581224322319031]}}


@pytest.mark.parametrize("kind", ["dense", "batched"])
def test_below_the_rule_the_draws_are_the_pinned_ones(kind):
    """3 rounds in one chunk with a crash re-election most rounds: each
    chunk's vote sheet (the generator's, after the init) and re-election
    sheet (the chaos stream's) handed to the round, and the elections,
    are the values the port drew before keyed dense rounds existed."""
    cfg = _cfg(num_rounds=3)
    chaos = ChaosSpec(crash_p=0.5)
    eng = (_batched if kind == "batched" else _dense)(cfg, chaos=chaos)
    assert not eng.keyed_tie_break
    f = eng.fused_round(3)
    seen = []
    dispatch = f.dispatch

    def spy(schedule, draws, *a, **k):
        inputs = [x for x in a if isinstance(x, dict)][0]
        seen.append((draws.clone(), np.array(inputs["reelect_draws"])))
        assert "rounds" not in k and "lane_ids" not in k
        return dispatch(schedule, draws, *a, **k)

    f.dispatch = spy
    pin = PINS[kind]
    f32 = np.float32
    if kind == "dense":
        res = eng.run_rounds(0, 3)
        draws, reelect = seen[0]
        assert tuple(draws.shape) == (3, 2, N)
        np.testing.assert_array_equal(draws[0].numpy(), f32(pin["draws[0]"]))
        np.testing.assert_array_equal(draws[2].numpy(), f32(pin["draws[2]"]))
        np.testing.assert_array_equal(reelect[1], f32(pin["reelect[1]"]))
        assert [-1 if r.aggregator is None else r.aggregator
                for r in res] == pin["aggregators"]
        np.testing.assert_array_equal(res[0].mse_scores,
                                      f32(pin["scores[0]"]))
        return
    outs, _, _ = eng.run_schedule_chunk(0, 3, np.ones(RUNS, bool))
    draws, reelect = seen[0]
    assert tuple(draws.shape) == (3, RUNS, 2, N)
    np.testing.assert_array_equal(draws[1][2].numpy(),
                                  f32(pin["draws[1][2]"]))
    np.testing.assert_array_equal(reelect[0][1], f32(pin["reelect[0][1]"]))
    assert [[o.aggregator for o in row] for row in outs] == \
        pin["aggregators"]
    np.testing.assert_array_equal(outs[0][0].scores,
                                  f32(pin["scores[0][0]"]))


# ------------------------------------ (d) batched keyed = each run alone ----

@pytest.mark.parametrize("hooks", ["clean", "attack+chaos",
                                   "elastic+straggler"])
def test_keyed_batched_runs_are_each_run_alone(hooks, monkeypatch):
    """Above the rule (lowered to 0, applied per run at (S, n_real)), R = 3
    batched keyed runs over one chunk of 3 rounds are the three runs
    alone, keyed, bit for bit: selections, elections, metrics, states and
    quota; each run reads its own keys."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    cfg = _cfg(num_participants=1.0)
    data = _data()

    def made():
        return {"clean": {},
                "attack+chaos": {"poison_fn": make_poison_fn(AttackSpec(
                    kind="noise", strength=0.5, start_round=1)),
                    "chaos": CRASH},
                "elastic+straggler": {
                    "elastic": ElasticSpec(leave_p=0.3, join_p=0.5),
                    "chaos": ChaosSpec(straggler_p=0.3, crash_p=0.5)}}[hooks]
    bat = _batched(cfg, data, **made())
    assert bat.keyed_tie_break
    rows = _batched_rows(bat, 3)
    f = bat.fused_round()
    assert f.u is None and tuple(f.tie_key["vote"].shape) == (RUNS, 4)
    for r in range(RUNS):
        alone = _dense(cfg, data, run=r, **made())
        assert alone.keyed_tie_break
        for got, want in zip(rows[r], alone.run_rounds(0, 3), strict=True):
            assert_same_round(got, want)
        assert_same_states(bat.states.apply(lambda t: t.chunk(RUNS)[r]),
                           alone.states)
        np.testing.assert_array_equal(bat.host[r].aggregation_count,
                                      alone.host.aggregation_count)


@pytest.mark.parametrize("chunk,pipelined", [(4, True), (3, True),
                                             (4, False)])
def test_keyed_batched_driver_stops_as_each_run_alone(chunk, pipelined,
                                                      monkeypatch):
    """The batched driver keyed, with per-run early stops (a mid-chunk
    stop's rewind and re-dispatch, a stop at a chunk's last round): each
    run's rounds, stop round, quota and final metrics are the sequential
    driver's keyed run, bit for bit."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    cfg = _cfg(num_rounds=6, fused_schedule_chunk=chunk, global_patience=1,
               num_runs=RUNS, fused_pipeline=pipelined)
    data = _data()
    seq = [run_combination(cfg, data, N, "hybrid", "mse_avg", r,
                           early_stop=GlobalEarlyStop(
                               inverted=True, patience=cfg.global_patience))
           for r in range(RUNS)]
    bat = run_batched_combination(cfg, data, N, "hybrid", "mse_avg")
    assert min(s["rounds_run"] for s in seq) < cfg.num_rounds
    for s, b in zip(seq, bat, strict=True):
        assert b["rounds_run"] == s["rounds_run"]
        assert b["aggregation_count"] == s["aggregation_count"]
        np.testing.assert_array_equal(b["final_metrics"], s["final_metrics"])
        for x, y in zip(b["rounds"], s["rounds"], strict=True):
            assert_same_round(x, y)


# ------------------------------------------------- (e) the padded axis ----

@pytest.mark.parametrize("kind", ["dense", "batched"])
@pytest.mark.parametrize("participants", [1.0, 0.5])
def test_keyed_run_padded_four_to_eight_elects_what_four_elect(
        kind, participants, monkeypatch):
    """Above the rule, 4 clients padded to 8: the same selections,
    elections, verification rows, results and real states bit for bit
    (the keyed rows read absolute ids, the pad lanes -1: a factor of
    1)."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    cfg = _cfg(num_participants=participants, num_rounds=3)
    if kind == "dense":
        plain, padded = _dense(cfg, _data()), _dense(cfg, _data(pad_to=PAD))
        assert plain.keyed_tie_break and padded.keyed_tie_break
        for got, want in zip(padded.run_rounds(0, 3), plain.run_rounds(0, 3),
                             strict=True):
            _same_round_bits(got, want)
        _same_real_states(padded.states, plain.states)
        return
    plain, padded = _batched(cfg, _data()), _batched(cfg, _data(pad_to=PAD))
    assert plain.keyed_tie_break and padded.keyed_tie_break
    for got, want in zip(_batched_rows(padded, 3), _batched_rows(plain, 3),
                         strict=True):
        for a, b in zip(got, want, strict=True):
            _same_round_bits(a, b)
    for r in range(RUNS):
        _same_real_states(padded.states.apply(lambda t: t.chunk(RUNS)[r]),
                          plain.states.apply(lambda t: t.chunk(RUNS)[r]))


# ------------------------------------------------- (f) the mesh, W = 2 ----

@pytest.fixture(scope="session")
def sessions(tmp_path_factory):
    return {2: rank_session(tmp_path_factory, 2)}


def test_keyed_mesh_on_two_ranks_is_the_keyed_run_on_one(sessions):
    """10 clients on 2 gloo ranks, every client selected, a crash
    re-election most rounds, the rule lowered to 0 in each rank: no rank
    holds a sheet, and the elections, verification rows and round-1
    winning scores are the keyed run's on one process; round-1 params
    within 1e-6 scale-normalized per leaf."""
    ranks, _ = sessions[2]
    got = ranks[0]["rounds_keyed"]
    want = jobs.run_engine_keyed(None, jobs.keyed_chaos_config(),
                                 chaos=jobs.keyed_chaos_spec())
    assert got["keyed"] and want["keyed"]
    assert not got["sheet"] and not want["sheet"]
    for a, b in zip(got["results"], want["results"], strict=True):
        assert a["selected"] == b["selected"]
        assert a["aggregator"] == b["aggregator"]
        assert a["crashed_aggregator"] == b["crashed_aggregator"]
        assert a["verification_results"] == b["verification_results"]
    assert any(r["crashed_aggregator"] is not None for r in want["results"])
    np.testing.assert_array_equal(got["results"][0]["mse_scores"],
                                  want["results"][0]["mse_scores"])
    for cols in jobs.LAYOUT.slices():
        close(got["params1"][:, cols], want["params1"][:, cols], 1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["rounds_keyed"]["params1"],
                                      got["params1"])


# --------------------------------------- (g) the chaos crash re-election ----

@pytest.mark.parametrize("participants", [1.0, 0.75])
def test_keyed_chaos_reelection_is_the_round_fed_the_keyed_sheet(
        participants, monkeypatch):
    """A crash most rounds: the keyed engine's vote and re-election read
    the keyed rows (no [T, S, N] horizon built, no re-election buffer);
    the engine below the rule fed the keyed hash's vote and re-election
    sheets runs the same 4 rounds bit for bit, crashes included."""
    cfg = _cfg(num_participants=participants, num_rounds=4)
    want_eng = _dense(cfg, cls=SheetEngine, chaos=CRASH)
    want = want_eng.run_rounds(0, 4)
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    got_eng = _dense(cfg, chaos=CRASH)
    got = got_eng.run_rounds(0, 4)
    assert any(r.crashed_aggregator is not None for r in want)
    for a, b in zip(got, want, strict=True):
        assert_same_round(a, b)
    _same_engines(got_eng, want_eng)
    assert got_eng._reelect_premade is None
    assert "reelect_draws" not in got_eng.fused_round().input_names


# ------------------------------------------ (h) the tier at C == N, keyed ----

@pytest.mark.parametrize("hooks", ["clean", "chaos"])
def test_keyed_tier_at_full_participation_is_the_keyed_dense_engine(
        hooks, monkeypatch):
    """The rule lowered to 0: the tier at C == N (its rule at (S, S))
    and the dense engine (at (S, N)) both key, compute the same rows for
    the same (round, voter position, absolute ids), and run the same 3
    rounds bit for bit: results, states and quota."""
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    n = 6
    cfg = _cfg(network_size=n, num_participants=1.0, num_rounds=3)
    kw = {"chaos": CRASH} if hooks == "chaos" else {}
    dense = _dense(cfg, **kw)
    want = dense.run_rounds(0, 3)
    tier = TieredRoundEngine(_model(cfg), cfg, _data(n), n_real=n,
                             rngs=ExperimentRngs(run=0), model_type="hybrid",
                             update_type="mse_avg", device="cpu", **kw)
    got = []
    tier.run_rounds(0, 3, lambda r, s: got.append(r) or False)
    assert dense.keyed_tie_break and tier.keyed_tie_break
    for a, b in zip(got, want, strict=True):
        assert_same_round(a, b)
    assert_same_states(tier.store.host, dense.states)
    np.testing.assert_array_equal(tier.host.aggregation_count,
                                  dense.host.aggregation_count)
