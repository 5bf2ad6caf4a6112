"""The port's network serving plane (fedmse_tpu_torch/net/) against the JAX
package's (fedmse_tpu/net/), on the CPU at small size (DIM 12, 4
gateways, buckets of 32): the counterpart of each test of
tests/test_net.py, plus cross-package checks.

Tolerances: wire frames and the decision objects (admission, session
isolation, the autoscaler's plans and decisions) are numpy and stdlib on
both sides and equal EXACTLY (bytes, traces); per-row statuses equal the
JAX plane's exactly and scores agree to 1e-5 (the forward kernel's plain
twin against XLA, PARITY.md §7), both planes built from the JAX init; a
worker process built from a seed scores the local replica's bits. Every
loopback test binds port 0 and bounds its waits.
"""

import io
import json
import os
import pickle
import select
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from fedmse_tpu.net import wire as jwire
from fedmse_tpu.net.admission import AdmissionController as JaxAdmission
from fedmse_tpu.net.admission import SessionIsolation as JaxIsolation
from fedmse_tpu.net.autoscale import BackendSpec as JaxBackend
from fedmse_tpu.net.autoscale import SLOAutoscaler as JaxAutoscaler
from fedmse_tpu.net.autoscale import plan_mix as jax_plan_mix
from fedmse_tpu.net.client import NetClient as JaxNetClient
from fedmse_tpu.net.server import FrontHandle as JaxFrontHandle
from fedmse_tpu.net.server import NetFront as JaxNetFront
from fedmse_tpu.serving import ServingRoster as JaxRoster
from fedmse_tpu_torch.net import wire
from fedmse_tpu_torch.net.admission import (AdmissionController,
                                            SessionIsolation)
from fedmse_tpu_torch.net.autoscale import (BackendSpec, SLOAutoscaler,
                                            plan_mix)
from fedmse_tpu_torch.net.client import (NetClient, NetClientError,
                                         RemoteReplica, host_payload)
from fedmse_tpu_torch.net.router import RouteResult, Router
from fedmse_tpu_torch.net.server import (FrontHandle, NetFront,
                                         _prepare_swap_payload,
                                         build_synthetic_replicas)
from fedmse_tpu_torch.serving import ServingRoster
from fedmse_tpu_torch.serving.engine import fit_gateway_centroids
from tests.torch_net_common import (DIM, N, jax_params, planes,
                                    port_engine)

pytestmark = pytest.mark.net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-5


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ------------------------------- wire ---------------------------------- #

def test_wire_roundtrip_and_guards():
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    gws = np.asarray([2, 0, 1], np.int32)
    tiers = np.asarray([0, 2, 1], np.uint8)
    buf = wire.FrameBuffer()
    buf.feed(wire.pack_submit(42, rows, gws, tiers))
    buf.feed(wire.pack_submit(43, rows, 1))  # broadcast gw, no tiers
    got = list(buf.frames())
    assert len(got) == 2
    rid, r2, g2, t2, t_sent = wire.unpack_submit(got[0])
    assert rid == 42 and t_sent > 0
    np.testing.assert_array_equal(r2, rows)
    np.testing.assert_array_equal(g2, gws)
    np.testing.assert_array_equal(t2, tiers)
    rid, _, g3, t3, _ = wire.unpack_submit(got[1])
    assert rid == 43 and g3.tolist() == [1, 1, 1] and t3.tolist() == [0] * 3
    frame = bytearray(wire.pack_submit(7, rows, gws, tiers, t_sent=1.0))
    struct.pack_into("!Q", frame, wire.REQUEST_ID_OFFSET, 99)
    struct.pack_into("!d", frame, wire.T_SENT_OFFSET, 123.5)
    rid, _, _, _, ts = wire.unpack_submit(memoryview(bytes(frame))[4:])
    assert rid == 99 and ts == 123.5
    st = np.asarray([0, 2, 3], np.uint8)
    sc = np.asarray([1.5, np.nan, np.nan], np.float32)
    buf.feed(wire.pack_result(42, st, sc))
    rid, st2, sc2 = wire.unpack_result(next(iter(buf.frames())))
    assert rid == 42 and st2.tolist() == [0, 2, 3]
    assert sc2[0] == 1.5 and np.isnan(sc2[1:]).all()
    buf2 = wire.FrameBuffer()
    buf2.feed(b"\xff\xff\xff\xff")
    with pytest.raises(wire.WireError, match="MAX_FRAME"):
        list(buf2.frames())
    frame = wire.pack_submit(1, rows, gws)
    with pytest.raises(wire.WireError, match="declared"):
        wire.unpack_submit(memoryview(frame[4:-2]))


def _frames(mod, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    rows = rng.normal(size=(n, DIM)).astype(np.float32)
    gws = rng.integers(0, 1000, n).astype(np.int32)
    tiers = rng.integers(0, 3, n).astype(np.uint8)
    st = rng.integers(0, 4, n).astype(np.uint8)
    sc = rng.normal(size=n).astype(np.float32)
    sc[st >= 2] = np.nan
    rid = int(rng.integers(0, 2 ** 63))
    return {
        "submit_tiers": mod.pack_submit(rid, rows, gws, tiers, t_sent=1.25),
        "submit_plain": mod.pack_submit(rid, rows, gws[0], t_sent=2.5),
        "result": mod.pack_result(rid, st, sc),
        "stats": mod.pack_control(mod.MSG_STATS, rid),
        "ack": mod.pack_control(mod.MSG_SWAP_ACK, rid, b'{"kinds": []}'),
        "error": mod.pack_control(mod.MSG_ERROR, rid, b"nope"),
        "close": mod.pack_control(mod.MSG_CLOSE),
    }


@pytest.mark.parametrize("seed", range(4))
def test_wire_frames_are_the_reference_bytes(seed):
    """SUBMIT, RESULT and control frames from the port equal the JAX
    package's bytes for the same inputs, and each package unpacks the
    other's frames to the same arrays."""
    ours, theirs = _frames(wire, seed), _frames(jwire, seed)
    assert ours == theirs
    for src, dst in ((wire, jwire), (jwire, wire)):
        fb = dst.FrameBuffer()
        fb.feed(b"".join(_frames(src, seed).values()))
        payloads = list(fb.frames())
        assert len(payloads) == len(ours)
        a = dst.unpack_submit(payloads[0])
        b = src.unpack_submit(memoryview(ours["submit_tiers"][4:]))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        ra, rb = dst.unpack_result(payloads[2]), src.unpack_result(
            memoryview(ours["result"][4:]))
        assert ra[0] == rb[0]
        np.testing.assert_array_equal(ra[1], rb[1])
        np.testing.assert_array_equal(_bits(ra[2]), _bits(rb[2]))
        assert [dst.parse_header(p)[0] for p in payloads[3:]] == [
            src.MSG_STATS, src.MSG_SWAP_ACK, src.MSG_ERROR, src.MSG_CLOSE]


def test_wire_guards_raise_in_both_packages():
    rows = np.ones((3, 4), np.float32)
    for mod in (wire, jwire):
        fb = mod.FrameBuffer()
        fb.feed(struct.pack("!I", mod.MAX_FRAME + 1))
        with pytest.raises(mod.WireError, match="MAX_FRAME"):
            list(fb.frames())
        short = mod.pack_submit(1, rows, 0)[4:-1]
        with pytest.raises(mod.WireError, match="declared"):
            mod.unpack_submit(memoryview(short))
        with pytest.raises(mod.WireError, match="same rows"):
            mod.pack_result(1, np.zeros(2, np.uint8), np.zeros(3))
    assert wire.MAX_FRAME == jwire.MAX_FRAME
    assert (wire.T_SENT_OFFSET, wire.REQUEST_ID_OFFSET) == (
        jwire.T_SENT_OFFSET, jwire.REQUEST_ID_OFFSET)
    assert wire.STATUS_NAMES == jwire.STATUS_NAMES


# --------------------- routing + exactly-once ------------------------- #

def _run(router, bursts, tiers=None):
    out = [router.submit_many(r, g, None if tiers is None else t)
           for (r, g), t in zip(bursts, tiers or [None] * len(bursts))]
    router.drain()
    assert all(r.finalize() for r in out)
    return (np.concatenate([r.statuses for r in out]),
            np.concatenate([r.scores for r in out]))


def test_router_scores_match_oracle_exactly_once():
    """Bursts striped across 2 replicas resolve per-row scores equal to the
    port's blocking engine and the JAX plane's (1e-5: on the CPU a row's
    bits may move with its bucket's row count), statuses equal to the JAX
    plane's, every row exactly once."""
    router, jrouter, cal, rows, gws, _, _ = planes()
    bursts = [(rows[s:s + 100], gws[s:s + 100]) for s in range(0, 600, 100)]
    st, got = _run(router, bursts)
    jst, jgot = _run(jrouter, bursts)
    want = router.replicas[0].engine.score(rows, gws)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL)
    np.testing.assert_allclose(got, jgot, atol=SCORE_TOL)
    np.testing.assert_array_equal(st, jst)
    np.testing.assert_array_equal(
        st, np.where(cal.verdicts(want, gws), wire.STATUS_ANOMALY,
                     wire.STATUS_NORMAL))
    served = [r.stats()["rows_served"] for r in router.replicas]
    assert all(s > 0 for s in served) and sum(served) == 600
    assert router.stats()["rows_routed"] == 600


def test_finalize_passes_remote_statuses_through():
    class FakeRemoteBlock:
        done = True
        scores = np.asarray([1.0, np.nan, np.nan], np.float32)
        verdicts = np.asarray([False, False, False])
        raw_statuses = np.asarray(
            [wire.STATUS_ANOMALY, wire.STATUS_SHED,
             wire.STATUS_UNKNOWN_GATEWAY], np.uint8)

    res = RouteResult(3)
    res._segs.append((FakeRemoteBlock(), np.arange(3)))
    assert res.finalize()
    assert res.statuses.tolist() == [wire.STATUS_ANOMALY, wire.STATUS_SHED,
                                     wire.STATUS_UNKNOWN_GATEWAY]


def test_router_unknown_gateway_terminates_at_router():
    """A retired slot's rows get STATUS_UNKNOWN_GATEWAY from the ROUTER: a
    burst of retired rows changes no replica's `engine.dispatches`, and
    in a mixed burst only the survivors are served; statuses equal the
    JAX plane's."""
    member = np.asarray([True, True, False, True])
    gen = np.asarray([0, 0, 1, 0])
    router, jrouter, _, rows, gws, _, _ = planes(
        roster=ServingRoster(member=member, generation=gen))
    jrouter.roster = JaxRoster(member=member, generation=gen)
    gws = np.asarray([0, 1, 3], np.int32)[gws % 3].copy()
    gws[:20] = 2
    before = [dict(rep.engine.dispatches) for rep in router.replicas]
    res = router.submit_many(rows[:20], gws[:20])
    router.drain()
    assert res.finalize()
    assert (res.statuses == wire.STATUS_UNKNOWN_GATEWAY).all()
    assert [dict(rep.engine.dispatches) for rep in router.replicas] == before
    st, sc = _run(router, [(rows[:100], gws[:100])])
    jst, jsc = _run(jrouter, [(rows[:100], gws[:100])])
    np.testing.assert_array_equal(st, jst)
    assert (st[:20] == wire.STATUS_UNKNOWN_GATEWAY).all()
    assert np.isnan(sc[:20]).all() and not np.isnan(sc[20:]).any()
    assert (st[20:] != wire.STATUS_UNKNOWN_GATEWAY).all()
    np.testing.assert_allclose(sc[20:], jsc[20:], atol=SCORE_TOL)
    assert sum(rep.stats()["rows_served"] for rep in router.replicas) == 80
    assert router.stats()["rows_unknown_gateway"] == 40


def test_roster_swap_mid_load_retires_and_broadcasts():
    """A mid-stream roster swap flips admission at the router for the very
    next burst and reaches every replica's engine; rows admitted before
    it still resolve, once."""
    router, _, _, rows, gws, _, _ = planes(jax_plane=False)
    gws = (np.arange(600) % N).astype(np.int32)
    r1 = router.submit_many(rows[:100], gws[:100])
    retired = ServingRoster(member=np.asarray([True, True, False, True]),
                            generation=np.asarray([0, 0, 1, 0]))
    event = router.swap(roster=retired)
    assert event["replicas"] == len(router.replicas)
    r2 = router.submit_many(rows[100:200], gws[100:200])
    router.drain()
    assert r1.finalize() and r2.finalize()
    assert (r1.statuses != wire.STATUS_UNKNOWN_GATEWAY).all()
    mask2 = gws[100:200] == 2
    assert (r2.statuses[mask2] == wire.STATUS_UNKNOWN_GATEWAY).all()
    assert (r2.statuses[~mask2] != wire.STATUS_UNKNOWN_GATEWAY).all()
    for rep in router.replicas:
        assert rep.engine.roster is retired
    assert sum(rep.stats()["rows_served"] for rep in router.replicas) == \
        100 + int((~mask2).sum())


# ----------------------------- shedding -------------------------------- #

def test_no_shedding_under_capacity():
    now = [0.0]
    router, _, _, rows, gws, _, _ = planes(
        capacity=10_000.0, clock=lambda: now[0], jax_plane=False)
    results = []
    for s in range(0, 600, 100):
        results.append(router.submit_many(rows[s:s + 100], gws[s:s + 100],
                                          tiers=(np.arange(100) % 3)))
        now[0] += 0.1
    router.drain()
    assert all(r.finalize() for r in results)
    statuses = np.concatenate([r.statuses for r in results])
    assert (statuses != wire.STATUS_SHED).all()
    assert router.admission.stats()["shed_total"] == 0


def test_shedding_lowest_tier_first_exactly_once():
    """Sustained overload sheds lowest tiers first, every row exactly one
    terminal status, admitted rows scored; the statuses and the
    controller's counters equal the JAX plane's under the same clock."""
    now = [0.0]
    router, jrouter, _, rows, gws, _, _ = planes(capacity=1000.0,
                                                 clock=lambda: now[0])
    tiers = np.asarray([0, 1, 2] * 200, np.uint8)
    out = {}
    for name, rt in (("port", router), ("jax", jrouter)):
        now[0] = 0.0
        r1 = rt.submit_many(rows, gws, tiers=tiers)
        r2 = rt.submit_many(rows, gws, tiers=tiers)
        rt.drain()
        assert r1.finalize() and r2.finalize()
        now[0] += 1.0
        r3 = rt.submit_many(rows[:300], gws[:300], tiers=tiers[:300])
        rt.drain()
        assert r3.finalize()
        out[name] = (r1, r2, r3, rt.admission.stats())
    r1, r2, r3, st = out["port"]
    for a, b in zip(out["port"][:3], out["jax"][:3]):
        np.testing.assert_array_equal(a.statuses, b.statuses)
    assert st == out["jax"][3]
    assert (r1.statuses != wire.STATUS_SHED).all()
    shed2 = r2.statuses == wire.STATUS_SHED
    assert shed2.sum() == 200 and (tiers[shed2] == 2).all()
    assert not np.isnan(r2.scores[~shed2]).any()
    assert np.isnan(r2.scores[shed2]).all()
    assert st["shed_by_tier"] == [0, 0, 200]
    assert st["offered_by_tier"] == [500, 500, 500]
    assert (r3.statuses != wire.STATUS_SHED).all()


def test_staleness_shed_is_tier_ordered_and_spares_tier0():
    adm = AdmissionController(tiers=3, stale_after_s=0.025,
                              clock=lambda: 0.0)
    tiers = np.asarray([0, 1, 2] * 4, np.uint8)
    assert adm.admit(tiers, now=0.0, age_s=0.01).all()
    m = adm.admit(tiers, now=0.0, age_s=0.03)
    assert (~m).sum() == 4 and (tiers[~m] == 2).all()
    m = adm.admit(tiers, now=0.0, age_s=0.06)
    assert (tiers[~m] >= 1).all() and m[tiers == 0].all()
    assert (~m).sum() == 8
    m = adm.admit(tiers, now=0.0, age_s=1e9)
    assert m[tiers == 0].all() and not m[tiers > 0].any()
    st = adm.stats()
    assert st["shed_by_tier"][0] == 0
    assert st["shed_by_tier"][1] <= st["shed_by_tier"][2]


@pytest.mark.parametrize("seed", range(4))
def test_stale_shed_counts_the_staleness_gate_alone(seed):
    """`stale_shed` holds, by tier, the rows the staleness gate shed: the
    rows of bursts older than their tier's limit, never tier 0. The rest
    of `shed` is the bucket's, which sheds nothing while the offered rate
    stays under capacity however old the bursts are."""
    rng = np.random.default_rng(seed)
    adm = AdmissionController(tiers=3, stale_after_s=0.025, headroom=0.9,
                              burst_s=0.25, clock=lambda: 0.0)
    adm.set_capacity(10_000.0)
    want = np.zeros(3, np.int64)
    now = 0.0
    for _ in range(200):
        now += 0.05        # 50 rows every 50 ms: a tenth of capacity
        t = rng.integers(0, 3, 50).astype(np.uint8)
        age = float(rng.uniform(0.0, 0.1))
        mask = adm.admit(t, now=now, age_s=age)
        stale = (t > 0) & (age > 0.025 * (3 - t.astype(np.int64)))
        np.testing.assert_array_equal(mask, ~stale)
        want += np.bincount(t[stale], minlength=3)
    assert want.sum() > 0
    np.testing.assert_array_equal(adm.stale_shed, want)
    np.testing.assert_array_equal(adm.shed, want)
    # overload with fresh bursts: the bucket sheds, the gate does not
    for _ in range(20):
        adm.admit(np.full(5_000, 2, np.uint8), now=now, age_s=0.0)
    np.testing.assert_array_equal(adm.stale_shed, want)
    assert adm.shed[2] > want[2] and adm.shed[0] == 0


def test_constructor_capacity_arms_a_full_bucket():
    adm = AdmissionController(tiers=3, capacity_rows_per_sec=100.0,
                              headroom=1.0, burst_s=1.0, clock=lambda: 0.0)
    assert adm.admit(np.asarray([0, 1, 2] * 30), now=0.0).all()
    assert adm.stats()["shed_total"] == 0


def test_partial_tier_shed_keeps_arrival_order():
    adm = AdmissionController(tiers=2, headroom=1.0, burst_s=1.0,
                              clock=lambda: 0.0)
    adm.set_capacity(10.0)
    tiers = np.asarray([1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1], np.uint8)
    admit = adm.admit(tiers, now=0.0)
    assert admit[[1, 4]].all()
    t1_pos = np.flatnonzero(tiers == 1)
    assert admit[t1_pos[:8]].all() and not admit[t1_pos[8:]].any()


@pytest.mark.parametrize("seed", range(6))
def test_admission_trace_equals_reference(seed):
    """Fed the same seeded tiers, sizes, ages and steps of one frozen
    clock, the port's controller admits the JAX one's rows, step by
    step, and ends with the same counters."""
    rng = np.random.default_rng(seed)
    tiers_n = int(rng.integers(1, 5))
    kw = dict(tiers=tiers_n, headroom=float(rng.uniform(0.5, 1.0)),
              burst_s=float(rng.uniform(0.05, 1.0)),
              stale_after_s=[None, 0.01][seed % 2])
    ours, theirs = AdmissionController(**kw), JaxAdmission(**kw)
    now = 0.0
    for step in range(120):
        if step in (0, 40, 80):
            cap = float(rng.uniform(500, 20_000))
            ours.set_capacity(cap)
            theirs.set_capacity(cap)
        now += float(rng.exponential(0.01))
        t = rng.integers(0, tiers_n, int(rng.integers(0, 400)))
        age = float(rng.uniform(0, 0.05)) if rng.random() < 0.5 else None
        np.testing.assert_array_equal(ours.admit(t, now=now, age_s=age),
                                      theirs.admit(t, now=now, age_s=age))
    assert ours.stats() == theirs.stats()


@pytest.mark.parametrize("seed", range(3))
def test_session_isolation_trace_equals_reference(seed):
    rng = np.random.default_rng(10 + seed)
    kw = dict(capacity_rows_per_sec=float(rng.uniform(1e3, 1e5)),
              session_share=float(rng.uniform(0.01, 0.5)),
              burst_s=float(rng.uniform(0.05, 1.0)))
    ours, theirs = SessionIsolation(**kw), JaxIsolation(**kw)
    now = 0.0
    for step in range(300):
        now += float(rng.exponential(0.005))
        key, n = int(rng.integers(0, 8)), int(rng.integers(0, 3000))
        assert ours.allow(key, n, now=now) == theirs.allow(key, n, now=now)
        if step == 150:
            ours.set_capacity(kw["capacity_rows_per_sec"] / 2)
            theirs.set_capacity(kw["capacity_rows_per_sec"] / 2)
            ours.forget(3)
            theirs.forget(3)
    assert ours.stats() == theirs.stats()


# ------------------------- swap during load ---------------------------- #

def test_params_swap_mid_load_atomic_per_replica():
    """A checkpoint + centroid broadcast mid-load: every replica's
    in-flight batch keeps the old regime, later batches score under the
    new one, zero tickets dropped or duplicated across 2 replicas."""
    router, _, _, rows, gws, _, train_x = planes(max_batch=16,
                                                 jax_plane=False)
    params2 = jax_params("hybrid", 9)
    eng2 = port_engine("hybrid", params2, train_x, 16)
    model = router.replicas[0].engine.model
    cens2 = fit_gateway_centroids(model, eng2.params, train_x)
    want_old = router.replicas[0].engine.score(rows, gws)
    want_new = eng2.score(rows, gws)
    results = [router.submit_many(rows[s:s + 50], gws[s:s + 50])
               for s in range(0, 300, 50)]
    event = router.swap(params=params2, centroids=cens2)
    results += [router.submit_many(rows[s:s + 50], gws[s:s + 50])
                for s in range(300, 600, 50)]
    router.drain()
    assert event["replicas"] == 2
    assert all(rep.engine.swap_count == 1 for rep in router.replicas)
    assert all(r.finalize() for r in results)
    got = np.concatenate([r.scores for r in results])
    assert len(got) == 600 and not np.isnan(got).any()
    old_ok = np.isclose(got, want_old, atol=SCORE_TOL)
    new_ok = np.isclose(got, want_new, atol=SCORE_TOL)
    assert (old_ok | new_ok).all()
    assert old_ok[:32].all()
    assert new_ok[300:].all()
    assert sum(rep.stats()["rows_served"] for rep in router.replicas) == 600


def test_swap_placed_in_executor_installs_without_copy():
    """The wire swap's executor-side placement puts params, centroids and
    banks on the engines' device and compute dtype; the loop-side install
    copies nothing (the installed tensors are the prepared ones), and the
    next dispatch scores under them."""
    _, _, _, rows, gws, _, train_x = planes(jax_plane=False)
    params = jax_params("hybrid", 0)
    engines = [port_engine("hybrid", params, train_x, 32,
                           score_kind="knn", knn_bank_size=16, knn_k=3)
               for _ in range(2)]
    from fedmse_tpu_torch.net.router import make_local_replicas
    router = Router(make_local_replicas(lambda i: engines[i], 2,
                                        max_batch=32))
    params2 = jax_params("hybrid", 5)
    fresh = port_engine("hybrid", params2, train_x, 32, score_kind="knn",
                        knn_bank_size=16, knn_k=3)
    body = pickle.dumps(host_payload({"params": fresh.params,
                                      "banks": fresh.banks}), 4)
    placed = _prepare_swap_payload(body, (engines[0].device,
                                          engines[0].policy.compute_dtype))
    router.swap(**placed)

    def ptrs(tree):
        return sorted(t.data_ptr() for t in _leaves(tree))

    for rep in router.replicas:
        eng = rep.engine
        assert ptrs(eng.params) == ptrs(placed["params"])
        assert eng.banks.latents.data_ptr() == \
            placed["banks"].latents.data_ptr()
        np.testing.assert_array_equal(
            _bits(eng.score(rows[:40], gws[:40])),
            _bits(fresh.score(rows[:40], gws[:40])))
    cen = fit_gateway_centroids(engines[0].model, engines[0].params, train_x)
    body = pickle.dumps(host_payload({"centroids": cen}), 4)
    placed = _prepare_swap_payload(body, (torch.device("cpu"),
                                          torch.float32))
    assert isinstance(placed["centroids"].mean, torch.Tensor)
    torch.testing.assert_close(placed["centroids"].mean, cen.mean,
                               rtol=0, atol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def test_remote_swap_sends_no_tensor():
    """RemoteReplica.swap pickles host arrays only: the port's tensors,
    ReferenceBank and CentroidClassifier cross the wire as numpy."""
    _, _, _, _, _, params, train_x = planes(jax_plane=False)
    eng = port_engine("hybrid", params, train_x, 32, score_kind="knn",
                      knn_bank_size=16, knn_k=3)
    cen = fit_gateway_centroids(eng.model, eng.params, train_x)
    sent = []

    class Capture(NetClient):
        def __init__(self):
            self.outstanding, self._next_id = {}, 1

        def _send(self, data):
            sent.append(data)

        def _wait_control(self, want, rid, timeout_s):
            return memoryview(wire.pack_control(
                wire.MSG_SWAP_ACK, rid, b'{"kinds": ["params"]}')[4:])

    rep = RemoteReplica.__new__(RemoteReplica)
    rep.client, rep.swap_events = Capture(), []
    rep.swap(params=eng.params, banks=eng.banks, centroids=cen,
             calibration=None)
    class NoTorch(pickle.Unpickler):
        def find_class(self, module, name):
            assert module.split(".")[0] != "torch", (module, name)
            return super().find_class(module, name)

    body = bytes(wire.body(memoryview(sent[0][4:])))
    payload = NoTorch(io.BytesIO(body)).load()
    seen = []

    def walk(v):
        assert not isinstance(v, torch.Tensor)
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif hasattr(v, "__dataclass_fields__"):
            for f in v.__dataclass_fields__:
                walk(getattr(v, f))
        elif isinstance(v, np.ndarray):
            seen.append(v)

    walk(payload)
    assert set(payload) == {"params", "banks", "centroids"}
    assert len(seen) == 8 + 2 + 3
    np.testing.assert_array_equal(
        payload["params"]["encoder"]["Dense_0"]["kernel"],
        eng.params["encoder"]["Dense_0"]["kernel"].numpy())


# ----------------------------- autoscaler ------------------------------ #

CPU = BackendSpec("cpu", rows_per_sec=100_000.0, usd_per_hour=0.10,
                  max_replicas=8)
ACC = BackendSpec("cuda", rows_per_sec=2_000_000.0, usd_per_hour=1.20,
                  max_replicas=4)


def test_cost_model_crossover():
    assert ACC.usd_per_megarow < CPU.usd_per_megarow
    assert plan_mix(50_000.0, [CPU, ACC], target_utilization=1.0) == \
        {"cpu": 1, "cuda": 0}
    mid = plan_mix(500_000.0, [CPU, ACC], target_utilization=1.0)
    assert mid == {"cpu": 5, "cuda": 0}
    high = plan_mix(4_000_000.0, [CPU, ACC], target_utilization=1.0)
    assert high["cuda"] >= 2
    jb = [JaxBackend(b.name, b.rows_per_sec, b.usd_per_hour, b.max_replicas)
          for b in (CPU, ACC)]
    for demand in np.geomspace(1e3, 2e7, 40):
        for tu in (0.6, 1.0):
            assert plan_mix(demand, [CPU, ACC], tu) == \
                jax_plan_mix(demand, jb, tu)


def test_autoscaler_budget_and_hysteresis():
    now = [0.0]
    sc = SLOAutoscaler(budget_ms=10.0, backends=[CPU, ACC],
                       target_utilization=0.6, scale_down_utilization=0.3,
                       min_bucket=64, max_bucket=4096, cooldown_s=5.0,
                       clock=lambda: now[0])
    d = sc.decide(arrival_rows_per_sec=150_000.0, p99_ms=4.0,
                  current={"cpu": 1})
    assert d.action == "scale_up" and d.total_replicas >= 3
    sc.mark_applied()
    now[0] += 1.0
    d = sc.decide(arrival_rows_per_sec=150_000.0, p99_ms=50.0,
                  current={"cpu": 1})
    assert d.action == "hold" and d.reason == "cooldown"
    now[0] += 10.0
    d = sc.decide(arrival_rows_per_sec=30_000.0, p99_ms=50.0,
                  current={"cpu": 1})
    assert d.action == "scale_up"
    assert d.bucket <= sc._pick_bucket(30_000.0, 1, p99_ms=None)
    sc.mark_applied()
    now[0] += 10.0
    d = sc.decide(arrival_rows_per_sec=10_000.0, p99_ms=2.0,
                  current={"cpu": 4})
    assert d.action == "scale_down" and d.total_replicas == 1
    assert sc._pick_bucket(1_600_000.0, 2, p99_ms=None) == 4096
    assert sc._pick_bucket(12_800.0, 1, p99_ms=None) == 128


@pytest.mark.parametrize("seed", range(3))
def test_autoscaler_decisions_equal_reference(seed):
    """SLOAutoscaler.decide over a seeded demand / p99 trace under one
    frozen clock: the port's decisions are the JAX package's, tick by
    tick (action, replicas, bucket, reason, cost)."""
    rng = np.random.default_rng(20 + seed)
    now = [0.0]
    kw = dict(budget_ms=10.0, target_utilization=0.6,
              scale_down_utilization=0.2, min_bucket=32, max_bucket=2048,
              cooldown_s=float(rng.uniform(0, 4)),
              scale_down_confirm_ticks=int(rng.integers(1, 4)),
              clock=lambda: now[0])
    ours = SLOAutoscaler(backends=[CPU, ACC], **kw)
    theirs = JaxAutoscaler(backends=[
        JaxBackend(b.name, b.rows_per_sec, b.usd_per_hour, b.max_replicas)
        for b in (CPU, ACC)], **kw)
    cur = {"cpu": 1, "cuda": 0}
    for _ in range(80):
        now[0] += float(rng.uniform(0.2, 2.0))
        arrival = float(rng.choice([5e3, 5e4, 4e5, 3e6]))
        p99 = None if rng.random() < 0.3 else float(rng.uniform(1, 20))
        a = ours.decide(arrival_rows_per_sec=arrival, p99_ms=p99,
                        current=cur)
        b = theirs.decide(arrival_rows_per_sec=arrival, p99_ms=p99,
                          current=cur)
        assert (a.action, a.replicas, a.bucket, a.reason, a.usd_per_hour) \
            == (b.action, b.replicas, b.bucket, b.reason, b.usd_per_hour)
        if a.action != "hold":
            cur = dict(a.replicas)
            ours.mark_applied()
            theirs.mark_applied()
    assert ours.stats() == theirs.stats()


def test_replica_resize_preserves_service():
    router, _, _, rows, gws, _, _ = planes(max_batch=32, jax_plane=False)
    r1 = router.submit_many(rows[:100], gws[:100])
    for rep in router.replicas:
        rep.resize(8)
    r2 = router.submit_many(rows[100:200], gws[100:200])
    router.drain()
    assert r1.finalize() and r2.finalize()
    assert all(rep.max_batch == 8 for rep in router.replicas)
    eng = router.replicas[0].engine
    np.testing.assert_allclose(np.concatenate([r1.scores, r2.scores]),
                               eng.score(rows[:200], gws[:200]),
                               atol=SCORE_TOL)


# --------------------------- TCP loopback ------------------------------ #

def test_net_front_loopback_end_to_end():
    """NIC-poll bursts over localhost TCP through 2 replicas, mixed tiers,
    a retired-gateway burst, a mid-stream threshold swap broadcast, stats
    over the wire: per-row statuses and scores equal to the in-process
    oracle, exactly once."""
    roster = ServingRoster(member=np.asarray([True, True, True, False]),
                           generation=np.asarray([0, 0, 0, 1]))
    router, _, cal, rows, gws, _, _ = planes(roster=roster, budget_ms=5.0,
                                             jax_plane=False)
    gws = np.arange(600, dtype=np.int32) % (N - 1)
    want = router.replicas[0].engine.score(rows, gws)
    handle = FrontHandle(NetFront(router))
    client = None
    try:
        client = NetClient("127.0.0.1", handle.port, timeout_s=30.0)
        rids = [client.submit(rows[s:s + 100], gws[s:s + 100],
                              tiers=(np.arange(100) % 3))
                for s in range(0, 300, 100)]
        bad_rid = client.submit(rows[:10], np.full(10, N - 1, np.int32))
        event = client.swap({"calibration": cal})
        assert event["kinds"] == ["thresholds"] and event["replicas"] == 2
        rids += [client.submit(rows[s:s + 100], gws[s:s + 100])
                 for s in range(300, 600, 100)]
        client.wait_all()
        got = np.concatenate([client.results[r][1] for r in rids])
        np.testing.assert_allclose(got, want, atol=SCORE_TOL)
        assert (client.results[bad_rid][0] ==
                wire.STATUS_UNKNOWN_GATEWAY).all()
        counts = client.status_counts()
        assert counts["unknown_gateway"] == 10 and counts["shed"] == 0
        assert sum(counts.values()) == client.rows_submitted == 610
        stats = client.stats()
        assert stats["router"]["replicas"] == 2
        assert stats["router"]["rows_served"] == 600
        assert stats["requests"] == 7
        with pytest.raises(NetClientError, match="nothing to swap"):
            client.swap({})
        tail = client.submit(rows[:50], gws[:50])
        client.wait_all()
        np.testing.assert_allclose(client.results[tail][1], want[:50],
                                   atol=SCORE_TOL)
    finally:
        if client is not None:
            client.close()
        handle.stop()


def test_shed_verdicts_over_the_wire():
    now = [0.0]
    router, _, _, rows, gws, _, _ = planes(
        capacity=1000.0, clock=lambda: now[0], budget_ms=5.0,
        jax_plane=False)
    handle = FrontHandle(NetFront(router))
    client = None
    try:
        client = NetClient("127.0.0.1", handle.port, timeout_s=30.0)
        tiers = np.asarray([0, 1, 2] * 200, np.uint8)
        r1 = client.submit(rows, gws, tiers=tiers)
        r2 = client.submit(rows, gws, tiers=tiers)
        client.wait_all()
        st1, st2 = client.results[r1][0], client.results[r2][0]
        assert (st1 != wire.STATUS_SHED).all()
        shed = st2 == wire.STATUS_SHED
        assert shed.sum() == 200 and (tiers[shed] == 2).all()
        assert sum(client.status_counts().values()) == 1200
    finally:
        if client is not None:
            client.close()
        handle.stop()


@pytest.mark.parametrize("direction", ["jax_client_port_front",
                                       "port_client_jax_front"])
def test_clients_and_fronts_interoperate_across_packages(direction):
    """The JAX NetClient streams to the port's NetFront and the port's
    NetClient to the JAX NetFront: statuses equal, scores within 1e-5 of
    the other plane's direct router; STATS replies parse on both."""
    router, jrouter, _, rows, gws, _, _ = planes(budget_ms=5.0)
    tiers = (np.arange(600) % 3).astype(np.uint8)
    want_st, want_sc = _run(
        jrouter if direction == "jax_client_port_front" else router,
        [(rows[s:s + 100], gws[s:s + 100]) for s in range(0, 600, 100)])
    if direction == "jax_client_port_front":
        handle, client_cls = FrontHandle(NetFront(router)), JaxNetClient
    else:
        handle, client_cls = JaxFrontHandle(JaxNetFront(jrouter)), NetClient
    client = None
    try:
        client = client_cls("127.0.0.1", handle.port, timeout_s=30.0)
        rids = [client.submit(rows[s:s + 100], gws[s:s + 100],
                              tiers=tiers[s:s + 100])
                for s in range(0, 600, 100)]
        client.wait_all()
        st = np.concatenate([client.results[r][0] for r in rids])
        sc = np.concatenate([client.results[r][1] for r in rids])
        np.testing.assert_array_equal(st, want_st)
        np.testing.assert_allclose(sc, want_sc, atol=SCORE_TOL)
        stats = client.stats()
        assert stats["router"]["rows_routed"] == 600
    finally:
        if client is not None:
            client.close()
        handle.stop()


def test_worker_process_scores_equal_local_replica_bits():
    """`python -m fedmse_tpu_torch.net.server --device cpu` behind a
    RemoteReplica: bucket by bucket, the worker's scores are the bits of
    a local replica built from the same seed; a router striping over both
    serves every row once; a swap reaches the worker (its swap_count
    advances), and it exits 0 on SIGTERM."""
    cmd = [sys.executable, "-m", "fedmse_tpu_torch.net.server", "--device",
           "cpu", "--replicas", "1", "--no-admission", "--seed", "0",
           "--gateways", str(N), "--dim", str(DIM), "--max-batch", "32",
           "--budget-ms", "5"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    remote = None
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120.0)
        assert ready, "the worker printed no listening line in 120 s"
        info = json.loads(proc.stdout.readline())
        local = build_synthetic_replicas(
            n_gateways=N, dim=DIM, replicas=1, max_batch=32,
            latency_budget_ms=5.0, seed=0, device="cpu")[0]
        remote = RemoteReplica("127.0.0.1", info["port"], num_gateways=N,
                               max_batch=32, timeout_s=30.0)
        rng = np.random.default_rng(4)
        rows = rng.normal(size=(256, DIM)).astype(np.float32)
        gws = rng.integers(0, N, 256).astype(np.int32)
        for s in range(0, 256, 32):  # one full bucket per burst
            blk = remote.submit_many(rows[s:s + 32], gws[s:s + 32])
            remote.drain()
            np.testing.assert_array_equal(
                _bits(blk.scores),
                _bits(local.engine.score(rows[s:s + 32], gws[s:s + 32])))
        router = Router([local, remote])
        res = router.submit_many(rows, gws)
        router.drain()
        assert res.finalize()
        np.testing.assert_allclose(res.scores, local.engine.score(rows, gws),
                                   atol=SCORE_TOL)
        router.swap(params=local.engine.params)
        worker = remote.stats()["router"]["per_replica"][0]
        assert worker["swap_count"] == 1
        remote.close()
        remote = None
        proc.terminate()
        proc.communicate(timeout=30)
        assert proc.returncode == 0
    finally:
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_cli_serve_net(tmp_path):
    """`fedmse_tpu_torch.main --serve-net --device cpu`: train ->
    checkpoint -> replicas -> router + admission -> localhost TCP ->
    verdicts, with the mid-stream threshold-swap broadcast."""
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.main import main as cli_main
    from tests.test_data import _write_client_csvs

    root = str(tmp_path / "shards")
    _write_client_csvs(root, 4, dim=6, n_normal=60, n_abnormal=24)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(DatasetConfig.for_client_dirs(root, 4).to_json(), f)
    out = cli_main([
        "--device", "cpu", "--dataset-config", cfg_path,
        "--model-types", "hybrid", "--update-types", "mse_avg",
        "--network-size", "4", "--dim-features", "6",
        "--epochs", "1", "--num-rounds", "1", "--batch-size", "8",
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--experiment-name", "serve-net", "--serve-rows", "256",
        "--serve-net", "--net-replicas", "2", "--serve-max-batch", "64",
    ])
    smoke = out["net_smoke"]
    assert smoke["replicas"] == 2 and smoke["port"] > 0
    assert smoke["rows_streamed"] > 0
    assert smoke["zero_dropped"] is True
    assert smoke["swap_broadcast"] is True
    counts = smoke["statuses"]
    assert sum(counts.values()) == smoke["rows_streamed"]
    assert counts["shed"] == 0 and counts["unknown_gateway"] == 0
    assert smoke["request_p99_ms"] > 0
    assert smoke["router"]["rows_served"] == smoke["rows_streamed"]
    json.dumps(smoke)
