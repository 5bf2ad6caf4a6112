"""Tiny CPU rehearsals of every cell through the harness that run.py
drives: the last line's keys, the per-layer metrics a CPU run may and may
not give, the comparison passing on the program and failing on each
fault planted under its timed path, and run.py's refusal without a card."""

import json
import time

import pytest
import torch

from benchmark import run
from benchmark.control import planted
from benchmark.drivers.federated_rounds import Deadline
from benchmark.harness import run_cell
from benchmark.tests.tiny import CELLS, SEED, tiny_cell

FAULTS = ("unchanged", "half_batch", "election", "score")


def rehearse(name, trace=False, seed=SEED):
    torch.set_num_threads(2)
    return run_cell(tiny_cell(name), seed, 0.5, trace, torch.device("cpu"),
                    time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_last_line(name, trace):
    result = rehearse(name, bool(trace))
    lines, last = run.report(result)
    out = json.loads(last)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "limits" and out["limits"]
    assert out["correct"] is True, lines
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if trace:
        # a CPU run reads no device metric and no host time of graphs
        assert names <= {"pipeline_host_gap_ms.train"}
    else:
        assert names == {"round_ms", "setup_s"}
    assert len(lines) == len(out["limits"])


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_comes_out_not_correct(name, kind):
    with planted(kind):
        result = rehearse(name)
    assert result["correct"] is False, result["numbers"]


@pytest.mark.parametrize("name", CELLS[:1])
def test_rehearsal_keeps_the_scores_of_position_three(name):
    from benchmark.drivers.federated_rounds import EVAL_CHUNK, SETUP_CHUNKS
    cell = tiny_cell(name)
    fed = cell.driver.setup(cell.config, cell.traffic, SEED,
                            torch.device("cpu"))
    evals = fed.setup_record["evals"]
    assert [e["position"] for e in evals] == [SETUP_CHUNKS[-1] - 1,
                                              EVAL_CHUNK - 1]
    assert EVAL_CHUNK - 1 >= 3
    n, t = cell.traffic["gateways"], evals[0]["scores"].shape[1]
    assert evals[-1]["scores"].shape == (n, t)
    assert fed.rounds_done == sum(SETUP_CHUNKS) + EVAL_CHUNK


def test_deadline_check_refuses_a_loop_that_runs_otherwise():
    d = Deadline(time.perf_counter() + 0.05, 4)
    n = 0
    while d > n:  # the loop as run_pipelined_schedule runs it
        n += min(4, d - n)
        time.sleep(0.01)
    d.check(n, n // 4)
    with pytest.raises(RuntimeError):
        d.check(n + 1, n // 4)  # a round beyond whole chunks
    with pytest.raises(RuntimeError):
        Deadline(time.perf_counter() + 60, 4).check(8, 2)  # no check held


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
