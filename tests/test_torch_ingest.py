"""The red team's ingest half (fedmse_tpu_torch/redteam/ingest.py) against
the JAX package's (fedmse_tpu/redteam/ingest.py): engine-free,
clock-injected simulations of the real decision objects (the router with
admission and session isolation; the SLO autoscaler), so the port's
results must equal the reference's EXACTLY: whole result dicts, step
traces and validation errors."""

import numpy as np
import pytest

from fedmse_tpu.redteam import ingest as jingest
from fedmse_tpu_torch.net.wire import STATUS_SHED
from fedmse_tpu_torch.redteam import (CostGamingAdversary, InstantReplica,
                                      ShedStormAdversary, cost_gaming_cell,
                                      shed_storm_cell)
from fedmse_tpu_torch.redteam import ingest

pytestmark = pytest.mark.redteam


@pytest.mark.parametrize("kw", [
    {},
    dict(ticks=60, honest=6, attackers=2, session_share=0.1, seed=3),
    dict(ticks=40, attackers=8, capacity=5_000.0, tick_s=0.02, seed=1),
])
def test_shed_storm_cell_equals_reference(kw):
    rows, summary = shed_storm_cell(**kw)
    jrows, jsummary = jingest.shed_storm_cell(**kw)
    assert rows == jrows
    assert summary == jsummary
    # the defense holds on the port's own run: the coalition's storm
    # sheds honest rows undefended and none defended, at no clean cost
    if not kw:
        assert summary["undefended_honest_shed_frac"] > 0.5
        assert summary["defended_honest_shed_frac"] == 0.0
        assert summary["clean_cost_shed_frac"] == 0.0
        assert summary["clean_rows_isolated"] == 0


@pytest.mark.parametrize("kw", [
    {},
    dict(ticks=120, confirm_defended=4, burst=50_000.0, honest_drop_tick=30),
    dict(cooldown_s=0.0, max_replicas=4, replica_rows_per_sec=12_000.0),
])
def test_cost_gaming_cell_equals_reference(kw):
    rows, summary = cost_gaming_cell(**kw)
    jrows, jsummary = jingest.cost_gaming_cell(**kw)
    assert rows == jrows
    assert summary == jsummary
    if not kw:
        assert summary["defended_scale_flaps"] < \
            summary["undefended_scale_flaps"]


def test_adversaries_step_like_the_reference():
    """The shed-storm rate search and the duty-cycle policy, fed the same
    feedback, take the JAX adversaries' steps."""
    rng = np.random.default_rng(0)
    a, b = ShedStormAdversary(n_sessions=3), jingest.ShedStormAdversary(
        n_sessions=3)
    for _ in range(200):
        assert a.next_rows() == b.next_rows()
        frac = float(rng.uniform(0, 0.2))
        a.observe(frac)
        b.observe(frac)
    c, d = CostGamingAdversary(), jingest.CostGamingAdversary()
    for supply in rng.uniform(0, 60_000, 100):
        assert c.next_load(float(supply)) == d.next_load(float(supply))


@pytest.mark.parametrize("make", [
    lambda mod: mod.ShedStormAdversary(n_sessions=0),
    lambda mod: mod.ShedStormAdversary(growth=1.0),
    lambda mod: mod.CostGamingAdversary(burst_rows_per_sec=10.0,
                                        idle_rows_per_sec=10.0),
])
def test_validation_errors_equal_reference(make):
    with pytest.raises(ValueError) as ours:
        make(ingest)
    with pytest.raises(ValueError) as theirs:
        make(jingest)
    assert str(ours.value) == str(theirs.value)


def test_instant_replica_completes_every_burst():
    """The replica-shaped sink completes on arrival and counts its rows;
    behind a router every row is admitted and scored 0."""
    from fedmse_tpu_torch.net.router import Router

    rep = InstantReplica(4, max_batch=8)
    router = Router([rep])
    res = router.submit_many(np.zeros((20, 3), np.float32),
                             np.arange(20) % 4)
    assert res.finalize()
    assert rep.rows_served == 20 and not (res.statuses == STATUS_SHED).any()
    np.testing.assert_array_equal(res.scores, np.zeros(20, np.float32))
    assert rep.poll() is False and rep.stats() == {
        "name": "instant", "rows_served": 20}
