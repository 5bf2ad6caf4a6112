"""The fused round's ledger and program spans (fedmse_tpu_torch/utils/
profiling.py, federation/fused.py, federation/pipeline.py) and the five
benchmark readers of the ledger (benchmark/metrics/), on the CPU:

  * the ledger counts a round's speculative epoch (epoch replays less
    `epochs_run`) and its lanes (the launch width x epoch replays; active:
    the round's `tracking` entries with the active column set), round by
    round, on the dense and the batched fused rounds;
  * chunk records are stamped and chained, and the deque stays bounded;
  * the resolution of marker events (fake CUDA events on a fake clock)
    tiles a chunk: bodies + idle = the marker-to-marker span, the chunk
    edge from the previous chunk's last marker, events reused;
  * under torch.profiler the `fused.*` spans nest per round and carry
    the round's index; with no profiler no `record_function` is entered;
  * each reader on canned records, and None for an empty window, for
    records outside it and off the card;
  * `PhaseTimer` on a card records device spans and never calls
    `torch.cuda.synchronize`.
"""

import collections
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine, run_pipelined_schedule
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils import profiling
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(1)

N = 6
METRICS = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / \
    "metrics"


def _cfg(**kw):
    # lr 0.2 and patience 1: some rounds stop early, some run every epoch
    kw.setdefault("num_rounds", 6)
    kw.setdefault("lr_rate", 0.2)
    return ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                            network_size=N, epochs=4, patience=1,
                            batch_size=8,
                            compat=CompatConfig(vote_tie_break=False), **kw)


def _data():
    clients = synthetic_clients(n_clients=N, dim=12, n_normal=120,
                                n_abnormal=60, seed=3)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    return stack_clients(clients, dev_x, 8, device="cpu")


def _model(cfg):
    return make_model("hybrid", 12, 8, 3, cfg.shrink_lambda, device="cpu")


def _engine(cfg, data):
    return RoundEngine(_model(cfg), cfg, data, n_real=N,
                       rngs=ExperimentRngs(run=0), model_type="hybrid",
                       update_type="mse_avg", fused=True)


@pytest.fixture
def chunks(monkeypatch):
    """A fresh, empty ledger deque for the test."""
    fresh = collections.deque(maxlen=profiling.CHUNKS_KEPT)
    monkeypatch.setattr(profiling, "_CHUNKS", fresh)
    return fresh


def _active(tracking) -> int:
    return int(np.sum(np.asarray(tracking)[..., 2] == 1))


def test_ledger_counts_speculative_epochs_and_lanes(chunks):
    eng = _engine(_cfg(), _data())
    results = []
    run_pipelined_schedule(eng, 0, 6, 3,
                           lambda rs, sec: results.extend(rs) or None,
                           can_rewind=False)
    rounds = [r for c in chunks for r in c["rounds"]]
    fused = eng._fused
    width = fused.co.p.shape[0]
    epochs = eng.cfg.epochs
    assert [r["round"] for r in rounds] == list(range(6))
    assert [r["epochs_run"] for r in rounds] == fused.epochs_run
    for rec, res in zip(rounds, results):
        speculative = rec["epoch_replays"] - rec["epochs_run"]
        assert speculative == (0 if rec["epochs_run"] == epochs else 1)
        assert rec["lanes"] == width * rec["epoch_replays"]
        assert rec["active_lanes"] == _active(res.tracking)
        assert 0 < rec["active_lanes"] <= width * rec["epochs_run"]
        assert all(rec[k] is None for k in profiling.ROUND_MS)
    # both kinds of round: a speculative epoch, and none
    assert {r["epoch_replays"] - r["epochs_run"] for r in rounds} == {0, 1}
    assert profiling.ledger_window(0.0, 1e12) is None  # no device time


def test_batched_round_ledger_counts_every_run(chunks):
    cfg = _cfg()
    eng = BatchedRunEngine(_model(cfg), cfg, _data(), n_real=N, runs=2,
                           model_type="hybrid", update_type="mse_avg")
    chunk = eng.dispatch_schedule_chunk(0, 3, np.ones(2, bool))
    outs, _, _ = eng.harvest_schedule_chunk(chunk)
    (record,) = chunks
    width = eng._fused.co.p.shape[0]
    for rec, runs in zip(record["rounds"], outs):
        assert rec["lanes"] == width * rec["epoch_replays"]
        assert rec["active_lanes"] == sum(_active(o.tracking) for o in runs)


def test_chunk_records_are_stamped_chained_and_bounded(monkeypatch):
    kept = collections.deque(maxlen=2)
    monkeypatch.setattr(profiling, "_CHUNKS", kept)
    eng = _engine(_cfg(num_rounds=8), _data())
    run_pipelined_schedule(eng, 0, 8, 2, lambda rs, sec: None,
                           can_rewind=False)
    assert len(kept) == 2 == len(profiling.recent_chunks())
    a, b = kept
    assert [a["first_round"], b["first_round"]] == [4, 6]
    assert b["edge_from"] == a["seq"]
    for c in (a, b):
        assert c["t_dispatch"] <= c["t_harvest"]
    # pipelined: the next chunk is dispatched before this one's harvest
    assert b["t_dispatch"] <= a["t_harvest"]


class _FakeEvent:
    """A CUDA event on a fake device clock (ms)."""

    now = 0.0
    made = 0

    def __init__(self, enable_timing=True):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = type(self).now

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_resolution_tiles_the_chunk(chunks, monkeypatch):
    """Marker events resolved into body and idle ms: bodies + idle = the
    first-to-last marker span; the chunk edge starts at the previous
    chunk's last marker; events come back to the pool but the last."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        None)
    _FakeEvent.now, _FakeEvent.made = 0.0, 0
    ledger = profiling.RoundLedger(torch.device("cpu"))
    ledger.cuda = True

    def body(rec, name, gap, ms):
        _FakeEvent.now += gap
        start = rec.marker()
        _FakeEvent.now += ms
        rec.body(name, start, rec.marker())

    def chunk(first, edge):
        rec = ledger.open(first, width=4)
        # round 1: 2 epochs trained and one speculative
        body(rec, "enter", edge, 1.0)
        for gap, ms in ((0.5, 5.0), (0.0, 5.0), (0.25, 4.0)):
            body(rec, "epoch", gap, ms)
        body(rec, "leave", 0.25, 2.0)
        rec.trained(2)
        # round 2: every epoch trained (3 of 3: none speculative)
        body(rec, "enter", 1.5, 1.0)
        for _ in range(3):
            body(rec, "epoch", 0.0, 3.0)
        body(rec, "leave", 0.0, 2.0)
        rec.trained(3)
        rec.sealed()
        return rec

    first = chunk(10, 0.0)
    second = chunk(12, 3.0)  # dispatched before the first is harvested
    one = first.close([8, 12])
    two = second.close([8, 12])
    r1, r2 = one["rounds"]
    assert (r1["epoch_replays"], r1["lanes"], r1["active_lanes"]) == \
        (3, 12, 8)
    assert r1["enter_ms"] == 1.0 and r1["train_ms"] == 10.0
    assert r1["speculative_ms"] == 4.0 and r1["leave_ms"] == 2.0
    assert r1["idle_in_round_ms"] == 1.0 and r1["idle_round_edge_ms"] == 0
    assert r2["train_ms"] == 9.0 and r2["speculative_ms"] == 0.0
    assert r2["idle_in_round_ms"] == 0.0 and r2["idle_round_edge_ms"] == 1.5
    body_ms = sum(r[k] for r in (r1, r2) for k in (
        "enter_ms", "train_ms", "speculative_ms", "leave_ms",
        "idle_in_round_ms", "idle_round_edge_ms"))
    assert body_ms == one["span_ms"] == 31.5
    assert one["idle_chunk_edge_ms"] is None and one["edge_from"] is None
    assert two["edge_from"] == one["seq"] and two["idle_chunk_edge_ms"] == 3
    # 2 x 20 markers made; all come back but each chunk's last
    assert _FakeEvent.made == 40 and len(ledger.pool) == 38
    window = profiling.ledger_window(one["t_dispatch"], 1e9)
    assert window["rounds"] == 4 and window["idle_chunk_edge_ms"] == 3.0
    third = chunk(14, 0.5)  # reuses the pool: no new event
    assert _FakeEvent.made == 40
    assert third.close([0, 0])["idle_chunk_edge_ms"] == 0.5


def _spans(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("fused.")]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_per_round_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(_cfg(), _data())
    run_pipelined_schedule(eng, 0, 2, 2, lambda rs, sec: None,
                           can_rewind=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_pipelined_schedule(eng, 2, 6, 2, lambda rs, sec: None,
                               can_rewind=False)
    spans = _spans(prof)
    by = collections.defaultdict(list)
    for s in spans:
        name, index = s[0].split("@")
        by[name].append((int(index), s))
    assert {i for i, _ in by["fused.round"]} == {2, 3, 4, 5}
    assert {i for i, _ in by["fused.dispatch"]} == {2, 4}
    assert {i for i, _ in by["fused.harvest"]} == {2, 4}
    assert {i for i, _ in by["fused.pipeline.consume"]} == {2, 4}
    rounds = dict(by["fused.round"])
    dispatch = dict(by["fused.dispatch"])
    for name in ("fused.enter", "fused.epoch", "fused.leave"):
        assert {i for i, _ in by[name]} == {2, 3, 4, 5}
        for i, s in by[name]:
            assert _within(s, rounds[i]), (name, i)
    for i, s in rounds.items():
        assert _within(s, dispatch[i - i % 2])
    for i, s in by["fused.upload"]:
        assert _within(s, dispatch[i])
    epochs = collections.Counter(i for i, _ in by["fused.epoch"])
    assert epochs == {r["round"]: r["epoch_replays"]
                      for c in profiling.recent_chunks()[-2:]
                      for r in c["rounds"]}


def test_no_record_function_without_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    eng = _engine(_cfg(), _data())
    run_pipelined_schedule(eng, 0, 4, 2, lambda rs, sec: None,
                           can_rewind=False)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        run_pipelined_schedule(eng, 4, 6, 2, lambda rs, sec: None,
                               can_rewind=False)
    assert entered and all(n.startswith("fused.") for n in entered)


# ---- the benchmark's readers of the ledger ---- #

def _round(**ms):
    rec = {"round": 0, "epochs_run": 2, "epoch_replays": 3, "lanes": 30,
           "active_lanes": 12, "enter_ms": 1.0, "train_ms": 40.0,
           "speculative_ms": 20.0, "leave_ms": 30.0,
           "idle_in_round_ms": 2.0, "idle_round_edge_ms": 1.0}
    rec.update(ms)
    return rec


def _chunk(seq, t_dispatch, t_harvest, rounds, edge_from=None, edge=0.0):
    return {"seq": seq, "first_round": 0, "t_dispatch": t_dispatch,
            "t_harvest": t_harvest, "edge_from": edge_from,
            "idle_chunk_edge_ms": edge, "span_ms": None, "rounds": rounds}


# the window [100, 110]: chunk 1 opens before it (its edge is outside),
# chunks 2 and 3 inside, chunk 4 harvested after the close
CANNED = [
    _chunk(1, 99.0, 100.5, [_round()]),
    _chunk(2, 100.0, 104.0, [_round(), _round(speculative_ms=0.0,
                                              epoch_replays=2, lanes=20,
                                              active_lanes=20)],
           edge_from=1, edge=5.0),
    _chunk(3, 103.0, 110.0, [_round(idle_round_edge_ms=0.0)],
           edge_from=2, edge=3.0),
    _chunk(4, 109.0, 110.5, [_round()], edge_from=3, edge=1.0),
]
# over chunks 2 and 3: 3 rounds; bodies 3 x 91 - 20; idle 3 x 3 - 1, and
# chunk 3's edge (chunk 2's is from chunk 1, outside the window)
EXPECTED = {
    "window_idle_share.train": 100.0 * (8.0 + 3.0) / (253.0 + 11.0),
    "train_device_ms.train": 40.0,
    "speculative_epoch_ms.train": 40.0 / 3,
    "leave_device_ms.train": 30.0,
    "active_lane_share.train": 100.0 * 44 / 80,
}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "ledger_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _ctx(on_card=True, t_open=100.0, window_s=10.0):
    return types.SimpleNamespace(on_card=on_card, window={
        "t_open": t_open, "window_s": window_s, "rounds": 3})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_canned_records(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling, "_CHUNKS", collections.deque(CANNED))
    assert read(_ctx()) == pytest.approx(EXPECTED[name])
    # off the card, or a window that holds no whole chunk: nothing
    assert read(_ctx(on_card=False)) is None
    assert read(_ctx(t_open=200.0)) is None
    assert read(_ctx(window_s=0.5)) is None
    monkeypatch.setattr(profiling, "_CHUNKS", collections.deque())
    assert read(_ctx()) is None
    # CPU records hold no device time
    cpu = [_chunk(2, 100.0, 104.0, [_round(**dict.fromkeys(
        profiling.ROUND_MS))])]
    monkeypatch.setattr(profiling, "_CHUNKS", collections.deque(cpu))
    assert read(_ctx()) is None


def test_phase_timer_reads_device_spans_without_synchronize(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.now = 0.0
    timer = profiling.PhaseTimer(enabled=True, device="cuda")
    for ms in (4.0, 6.0):
        with timer.phase("train"):
            _FakeEvent.now += ms
    with timer.phase("vote"):
        _FakeEvent.now += 1.5
    assert calls == []
    assert timer.timings() == pytest.approx({"train": 0.010,
                                             "vote": 0.0015})
    assert timer.timings() == pytest.approx({"train": 0.010,
                                             "vote": 0.0015})
    timer.reset()
    assert timer.timings() == {} and calls == []
