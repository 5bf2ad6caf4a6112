"""The port's fused schedule drivers (fedmse_tpu_torch/main.py
run_combination, federation/pipeline.py): the pipelined chunk loop (the
default), the serial chunk loop (--no-pipeline) and the per-round loops
(fused_schedule=False; fused_rounds=False, the per-phase path) must end on
the same final states and write the same artifacts, bit for bit on the
CPU, with and without a global early stop: a stop before a chunk's last
round rewinds to the chunk's entry and replays the prefix with the same
selections; a stop at its last round, with the next chunk in flight,
takes that chunk's entry snapshot and discards it. The defaults are the
JAX package's (fedmse_tpu/config.py)."""

import os

import numpy as np
import pytest
import torch

from fedmse_tpu.config import ExperimentConfig as JaxConfig
from fedmse_tpu_torch.checkpointing import ResultsWriter
from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.federation import RoundEngine, run_pipelined_schedule
from fedmse_tpu_torch.main import GlobalEarlyStop, build_parser, main
from fedmse_tpu_torch.main import run_combination
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

torch.set_num_threads(1)

N = 4
DRIVERS = {"pipelined": {}, "serial": dict(fused_pipeline=False),
           "per_round": dict(fused_schedule=False),
           "per_phase": dict(fused_rounds=False)}


def _cfg(**kw):
    kw.setdefault("num_rounds", 4)
    return ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                            network_size=N, epochs=2, batch_size=8,
                            compat=CompatConfig(vote_tie_break=False), **kw)


def _data(seed):
    clients = synthetic_clients(n_clients=N, dim=12, n_normal=120,
                                n_abnormal=60, seed=seed)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    return stack_clients(clients, dev_x, 8, device="cpu")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = p
    return out


def _assert_same_artifacts(root_a, root_b):
    a, b = _files(root_a), _files(root_b)
    assert set(a) == set(b) and a
    for rel in a:
        if rel.endswith(".npz"):  # zip entries carry their write time
            with np.load(a[rel]) as x, np.load(b[rel]) as y:
                assert x.files == y.files
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=rel)
        else:
            with open(a[rel], "rb") as x, open(b[rel], "rb") as y:
                assert x.read() == y.read(), rel


def _run_drivers(tmp_path, cfg, data, model_type, update_type,
                 early_stop=False):
    outs = {}
    for name, kw in DRIVERS.items():
        c = cfg.replace(**kw)
        root = str(tmp_path / name)
        writer = ResultsWriter(root, c.network_size, c.experiment_name,
                               c.scen_name, c.metric, c.num_participants)
        out = run_combination(
            c, data, N, model_type, update_type, 0, writer=writer,
            early_stop=GlobalEarlyStop() if early_stop else None,
            device_names=[f"dev-{i}" for i in range(N)],
            save_checkpoints=True)
        outs[name] = (out, root)
    return outs


def _assert_drivers_agree(outs):
    ref, ref_root = outs["per_phase"]
    for name, (out, root) in outs.items():
        assert out["rounds_run"] == ref["rounds_run"], name
        assert out["aggregation_count"] == ref["aggregation_count"], name
        assert out["votes_received"] == ref["votes_received"], name
        np.testing.assert_array_equal(out["final_metrics"],
                                      ref["final_metrics"], err_msg=name)
        a, b = out["engine"].states, ref["engine"].states
        for field in ("params", "prev_global", "hist_params", "rejected"):
            assert torch.equal(getattr(a, field), getattr(b, field)), name
        for x, y in zip(a.opt_state, b.opt_state):
            assert torch.equal(x, y), name
        _assert_same_artifacts(root, ref_root)


@pytest.mark.parametrize("chunk", [1, 3])
def test_drivers_write_the_same_artifacts(tmp_path, chunk):
    """Without early stop: pipelined == serial == per-round fused ==
    per-phase, states and artifact trees, for chunks of 1 and 3 (4 rounds:
    a short last chunk)."""
    outs = _run_drivers(tmp_path, _cfg(fused_schedule_chunk=chunk),
                        _data(0), "hybrid", "mse_avg")
    assert outs["pipelined"][0]["rounds_run"] == 4
    _assert_drivers_agree(outs)


# (model_type, update_type, data seed, chunk, the stop round's 0-based
# index): autoencoder/avg reaches AUC 1 at once, so the inverted early stop
# fires at round index 2; hybrid/mse_avg on seed 1 fires at index 4
STOPS = {"mid_chunk": ("autoencoder", "avg", 0, 2, 2),
         "last_round_of_chunk": ("autoencoder", "avg", 0, 3, 2),
         "chunks_of_one": ("autoencoder", "avg", 0, 1, 2),
         "mid_chunk_later": ("hybrid", "mse_avg", 1, 3, 4)}


@pytest.mark.parametrize("case", sorted(STOPS))
def test_early_stop_ends_on_the_per_round_states(tmp_path, case):
    model_type, update_type, seed, chunk, stop = STOPS[case]
    outs = _run_drivers(tmp_path, _cfg(num_rounds=8,
                                       fused_schedule_chunk=chunk),
                        _data(seed), model_type, update_type,
                        early_stop=True)
    assert outs["per_phase"][0]["rounds_run"] == stop + 1
    # the stop's place in its chunk: before the chunk's last round (a
    # rewind and a replay) or at it (the successor's entry snapshot)
    at_last = stop % chunk == chunk - 1
    assert at_last == (case in ("last_round_of_chunk", "chunks_of_one"))
    _assert_drivers_agree(outs)


def _engine(cfg, data):
    return RoundEngine(make_model("hybrid", 12, 8, 3, cfg.shrink_lambda,
                                  device="cpu"), cfg, data, n_real=N,
                       rngs=ExperimentRngs(run=0), model_type="hybrid",
                       update_type="mse_avg", fused=True)


def test_dispatch_harvest_split_carries_the_quota_on_the_device():
    """Chunk 2 dispatched on chunk 1's device quota before chunk 1 is
    harvested == two chunks run one after the other."""
    cfg, data = _cfg(num_rounds=6), _data(0)
    ref = _engine(cfg, data)
    want = ref.run_schedule_chunk(0, 3)[0] + ref.run_schedule_chunk(3, 3)[0]
    eng = _engine(cfg, data)
    c1 = eng.dispatch_schedule_chunk(0, 3, snapshot=True)
    c2 = eng.dispatch_schedule_chunk(3, 3, agg_count=c1.agg_count)
    got = (eng.harvest_schedule_chunk(c1)[0]
           + eng.harvest_schedule_chunk(c2)[0])
    for a, b in zip(got, want):
        assert a.selected == b.selected and a.aggregator == b.aggregator
        np.testing.assert_array_equal(a.client_metrics, b.client_metrics)
        np.testing.assert_array_equal(a.min_valid, b.min_valid)
    assert eng.host.aggregation_count.tolist() == \
        ref.host.aggregation_count.tolist()
    assert torch.equal(eng.states.params, ref.states.params)
    # the snapshot is chunk 1's entry: the engine's init
    assert torch.equal(c1.snap_states.params,
                       _engine(cfg, data).states.params)


def test_pipeline_overlap_telemetry():
    """Each next chunk is enqueued before the previous one is harvested:
    the host gaps are negative by construction."""
    cfg = _cfg(num_rounds=9)
    eng = _engine(cfg, _data(0))
    seen = []
    stats = run_pipelined_schedule(
        eng, 0, cfg.num_rounds, 3,
        lambda results, sec: seen.extend(results) or None, can_rewind=False)
    assert [r.round_index for r in seen] == list(range(9))
    assert stats.chunks == 3 and len(stats.host_gaps) == 2
    assert all(g <= 0 for g in stats.host_gaps)
    assert stats.summary()["overlapped"] is True


def test_a_chunk_of_no_rounds_is_refused():
    with pytest.raises(ValueError, match="fused_schedule_chunk"):
        run_combination(_cfg(fused_schedule_chunk=0), _data(0), N, "hybrid",
                        "mse_avg", 0)


def test_defaults_match_the_jax_config_and_no_pipeline_flag(monkeypatch,
                                                            tmp_path):
    for name in ("fused_rounds", "fused_schedule", "fused_schedule_chunk",
                 "fused_pipeline"):
        assert getattr(ExperimentConfig(), name) == getattr(JaxConfig(), name)
    opts = {s for a in build_parser()._actions for s in a.option_strings}
    assert {"--no-pipeline", "--fused-rounds", "--fused-schedule",
            "--fused-schedule-chunk", "--fused-pipeline"} <= opts
    seen = {}

    def fake_run_experiment(cfg, dataset, **kw):
        seen["cfg"] = cfg
        return {}
    monkeypatch.setattr("fedmse_tpu_torch.main.run_experiment",
                        fake_run_experiment)
    cfg_path = tmp_path / "ds.json"
    cfg_path.write_text('{"data_path": "x", "devices_list": []}')
    main(["--dataset-config", str(cfg_path)])
    assert seen["cfg"].fused_pipeline is True
    main(["--dataset-config", str(cfg_path), "--no-pipeline",
          "--fused-schedule-chunk", "4"])
    assert seen["cfg"].fused_pipeline is False
    assert seen["cfg"].fused_schedule_chunk == 4
