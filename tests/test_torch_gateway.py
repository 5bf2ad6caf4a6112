"""The port's gateway ingest plane (fedmse_tpu_torch/gateway/) against the
JAX package's (fedmse_tpu/gateway/), on the CPU at small size (DIM 12, 16
gateways, buckets of 32): the counterpart of each test of
tests/test_gateway.py, plus cross-package checks.

Tolerances: mux frames, derived keys and transcript MACs are stdlib on
both sides and equal as BYTES; the frontend's verdicts and scores equal
a direct port Router's over the same fleet bit for bit (the same bucket
shapes), and the JAX plane's statuses exactly with scores to 1e-5 (the
plain twin against XLA). Every reject path keeps `rows_parsed` at 0.
Every loopback test binds port 0 and bounds its waits.
"""

import time

import numpy as np
import pytest

from fedmse_tpu.gateway import auth as jauth
from fedmse_tpu.gateway import mux as jmux
from fedmse_tpu.gateway.client import GatewayClient as JaxGatewayClient
from fedmse_tpu.gateway.session import SessionTable as JaxSessionTable
from fedmse_tpu.net.autoscale import BackendSpec as JaxBackend
from fedmse_tpu.net.autoscale import FrontendSpec as JaxFrontendSpec
from fedmse_tpu.net.autoscale import plan_split as jax_plan_split
from fedmse_tpu.net.router import Router as JaxRouter
from fedmse_tpu.net.router import make_local_replicas as jax_replicas
from fedmse_tpu.serving import ServingEngine as JaxEngine
from fedmse_tpu_torch.gateway import auth, mux
from fedmse_tpu_torch.gateway.client import GatewayClient
from fedmse_tpu_torch.gateway.frontend import (FrontendHandle,
                                               GatewayFrontend,
                                               build_synthetic_frontend)
from fedmse_tpu_torch.gateway.session import SessionTable
from fedmse_tpu_torch.gateway.stripe import FailoverStripe
from fedmse_tpu_torch.net import wire
from fedmse_tpu_torch.net.admission import SessionIsolation
from fedmse_tpu_torch.net.autoscale import (BackendSpec, FrontendSpec,
                                            SLOAutoscaler, plan_split)
from fedmse_tpu_torch.net.router import Router, make_local_replicas
from fedmse_tpu_torch.net.server import build_synthetic_replicas
from fedmse_tpu_torch.redteam.ingest import InstantReplica
from fedmse_tpu_torch.serving import ServingRoster
from tests.torch_net_common import jax_params, port_engine, wait_for

pytestmark = pytest.mark.gateway

DIM = 12
N = 16


def _wait_reject(client, code, timeout_s=20.0):
    wait_for(lambda: (client.poll(),
                      any(c == code for _, c, _ in client.rejects))[1],
             timeout_s=timeout_s)


def _small_front(**kw):
    kw.setdefault("n_gateways", N)
    kw.setdefault("dim", DIM)
    kw.setdefault("replicas", 1)
    kw.setdefault("max_batch", 32)
    kw.setdefault("model_type", "autoencoder")
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return build_synthetic_frontend(**kw)


# ------------------------------- wire ---------------------------------- #

def test_mux_roundtrips():
    fb = wire.FrameBuffer()
    cn, sn = auth.new_nonce(), auth.new_nonce()
    token = auth.new_nonce()
    rows = np.arange(3 * DIM, dtype=np.float32).reshape(3, DIM)
    statuses = np.array([0, 1, 2], np.uint8)
    scores = np.array([0.5, 2.0, np.nan], np.float32)
    fb.feed(mux.pack_hello(7, 3, cn))
    fb.feed(mux.pack_challenge(7, sn))
    fb.feed(mux.pack_auth(7, b"m" * mux.MAC_LEN))
    fb.feed(mux.pack_welcome(7, token))
    fb.feed(mux.pack_reject(9, mux.REJ_BAD_MAC, "nope"))
    fb.feed(mux.pack_submit(7, 11, token, rows, tier=2))
    fb.feed(mux.pack_result(7, 11, statuses, scores))
    fb.feed(mux.pack_simple(mux.G_PING, 7, 5))
    frames = list(fb.frames())
    assert [mux.parse_gheader(p)[0] for p in frames] == [
        mux.G_HELLO, mux.G_CHALLENGE, mux.G_AUTH, mux.G_WELCOME,
        mux.G_REJECT, mux.G_SUBMIT, mux.G_RESULT, mux.G_PING]
    assert mux.unpack_hello(frames[0]) == (7, 3, cn)
    assert mux.unpack_challenge(frames[1]) == (7, sn)
    assert mux.unpack_auth(frames[2]) == (7, b"m" * mux.MAC_LEN)
    assert mux.unpack_welcome(frames[3]) == (7, token)
    assert mux.unpack_reject(frames[4]) == (9, mux.REJ_BAD_MAC, "nope")
    assert mux.submit_token(frames[5]) == token
    seq, r2, tier, t_sent = mux.unpack_submit_rows(frames[5])
    assert seq == 11 and tier == 2 and t_sent > 0
    np.testing.assert_array_equal(np.asarray(r2), rows)
    rgid, rseq, st2, sc2 = mux.unpack_result(frames[6])
    assert (rgid, rseq) == (7, 11)
    np.testing.assert_array_equal(st2, statuses)
    np.testing.assert_array_equal(sc2, scores)


def _mux_frames(mod, seed):
    rng = np.random.default_rng(seed)
    gid, seq = int(rng.integers(0, 2 ** 32)), int(rng.integers(0, 2 ** 63))
    cn, sn, tok = (rng.bytes(16) for _ in range(3))
    mac = rng.bytes(32)
    n = int(rng.integers(1, 30))
    rows = rng.normal(size=(n, DIM)).astype(np.float32)
    st = rng.integers(0, 4, n).astype(np.uint8)
    sc = rng.normal(size=n).astype(np.float32)
    return [
        mod.pack_hello(gid, int(rng.integers(0, 9)), cn),
        mod.pack_challenge(gid, sn), mod.pack_auth(gid, mac),
        mod.pack_welcome(gid, tok),
        mod.pack_reject(gid, mod.REJ_BAD_TOKEN, "bad token"),
        mod.pack_submit(gid, seq, tok, rows, tier=2, t_sent=3.5),
        mod.pack_result(gid, seq, st, sc),
        mod.pack_simple(mod.G_PING, gid, seq),
        mod.pack_simple(mod.G_BYE, gid),
        mod.pack_simple(mod.G_STATS, 0, seq),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_mux_frames_are_the_reference_bytes(seed):
    """Every mux frame from the port equals the JAX package's bytes for
    the same inputs, and each package unpacks the other's; the token
    sits ahead of the rows in both (submit_token reads no row byte)."""
    ours, theirs = _mux_frames(mux, seed), _mux_frames(jmux, seed)
    assert ours == theirs
    assert (mux.HEADER_LEN, mux.T_SENT_OFFSET, mux.SEQ_OFFSET) == (
        jmux.HEADER_LEN, jmux.T_SENT_OFFSET, jmux.SEQ_OFFSET)
    for src, dst in ((mux, jmux), (jmux, mux)):
        p = [memoryview(f[4:]) for f in _mux_frames(src, seed)]
        assert dst.unpack_hello(p[0]) == src.unpack_hello(p[0])
        assert dst.unpack_challenge(p[1]) == src.unpack_challenge(p[1])
        assert dst.unpack_auth(p[2]) == src.unpack_auth(p[2])
        assert dst.unpack_welcome(p[3]) == src.unpack_welcome(p[3])
        assert dst.unpack_reject(p[4]) == src.unpack_reject(p[4])
        assert dst.submit_token(p[5]) == src.submit_token(p[5])
        a, b = dst.unpack_submit_rows(p[5]), src.unpack_submit_rows(p[5])
        assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
        np.testing.assert_array_equal(a[1], b[1])
        ra, rb = dst.unpack_result(p[6]), src.unpack_result(p[6])
        assert ra[:2] == rb[:2]
        np.testing.assert_array_equal(ra[2], rb[2])
        np.testing.assert_array_equal(ra[3].view(np.int32),
                                      rb[3].view(np.int32))
        assert [dst.parse_gheader(x)[0] for x in p[7:]] == [
            src.G_PING, src.G_BYE, src.G_STATS]
    short = memoryview(ours[5][4:4 + mux.HEADER_LEN + 8])
    for mod in (mux, jmux):
        with pytest.raises(mod.WireError, match="malformed"):
            mod.submit_token(short)


def test_framebuffer_offset_consumption():
    fb = wire.FrameBuffer()
    frames = [mux.pack_simple(mux.G_PING, i) for i in range(50)]
    blob = b"".join(frames)
    got = []
    for i in range(0, len(blob), 7):
        fb.feed(blob[i:i + 7])
        got.extend(mux.parse_gheader(p)[2] for p in fb.frames())
    assert got == list(range(50))
    assert len(fb) == 0
    assert fb._off == 0


def test_auth_key_derivation_and_mac():
    master = auth.master_key(seed=3)
    k = auth.gateway_key(master, 5, 0)
    assert k != auth.gateway_key(master, 6, 0)
    assert k != auth.gateway_key(master, 5, 1)
    cn, sn = auth.new_nonce(), auth.new_nonce()
    mac = auth.session_mac(k, 5, 0, cn, sn)
    assert auth.verify_session_mac(k, 5, 0, cn, sn, mac)
    assert not auth.verify_session_mac(k, 5, 0, sn, cn, mac)
    wrong = auth.gateway_key(master, 5, 1)
    assert not auth.verify_session_mac(wrong, 5, 0, cn, sn, mac)


@pytest.mark.parametrize("seed", [0, 1, 7, -3])
def test_auth_bytes_equal_reference(seed):
    """master_key(seed=), the per-gateway key derivation and the
    transcript MAC are the JAX package's bytes; each side verifies the
    other's MAC."""
    assert auth.master_key(seed=seed) == jauth.master_key(seed=seed)
    hexkey = "00112233445566778899aabbccddeeff" * 2
    assert auth.master_key(hexkey) == jauth.master_key(hexkey)
    for mod in (auth, jauth):
        with pytest.raises(ValueError, match="16 bytes"):
            mod.master_key("00ff")
    rng = np.random.default_rng(abs(seed))
    master = auth.master_key(seed=seed)
    for _ in range(8):
        gid, gen = int(rng.integers(0, 2 ** 32)), int(rng.integers(0, 99))
        cn, sn = rng.bytes(16), rng.bytes(16)
        k = auth.gateway_key(master, gid, gen)
        assert k == jauth.gateway_key(master, gid, gen)
        mac = auth.session_mac(k, gid, gen, cn, sn)
        assert mac == jauth.session_mac(k, gid, gen, cn, sn)
        assert jauth.verify_session_mac(k, gid, gen, cn, sn, mac)
        assert auth.verify_session_mac(k, gid, gen, cn, sn, mac)
        assert not auth.verify_session_mac(k, gid, gen + 1, cn, sn, mac)


# ----------------------- handshake: the identity gate ------------------- #

def test_handshake_rejects_terminate_before_any_row_parse():
    front = _small_front(warmup=False, calibrate=False)
    front.router.roster.member[3] = False
    h = FrontendHandle(front)
    master = auth.master_key(seed=0)
    c = bad = None
    try:
        c = GatewayClient("127.0.0.1", h.port, master=master,
                          timeout_s=20.0)
        assert not c.authenticate(N + 50)
        assert not c.authenticate(3)
        assert not c.authenticate(4, generation=9)
        assert [code for _, code, _ in c.rejects] == [
            mux.REJ_UNKNOWN_GATEWAY] * 3
        bad = GatewayClient("127.0.0.1", h.port,
                            key_fn=lambda g, gen: b"\x00" * 32,
                            timeout_s=20.0)
        assert not bad.authenticate(5)
        assert bad.rejects[-1][1] == mux.REJ_BAD_MAC
        assert c.authenticate(2)
        rows = np.zeros((4, DIM), np.float32)
        c._send(mux.pack_submit(2, 1, b"\x00" * mux.TOKEN_LEN, rows))
        _wait_reject(c, mux.REJ_BAD_TOKEN)
        assert front.rows_parsed == 0
        assert front.rejects["unknown_gateway"] == 3
        assert front.rejects["bad_mac"] == 1
        assert front.rejects["bad_token"] == 1
    finally:
        for cl in (c, bad):
            if cl is not None:
                cl.close()
        h.stop()


def test_session_reuse_parking_and_roster_eviction():
    front = _small_front(park_after_s=0.15)
    h = FrontendHandle(front)
    c = None
    try:
        c = GatewayClient("127.0.0.1", h.port,
                          master=auth.master_key(seed=0), timeout_s=20.0)
        assert c.authenticate_many(range(4)) == 4
        rng = np.random.default_rng(1)
        for _ in range(3):
            for gid in range(4):
                c.submit(gid, rng.normal(size=(8, DIM)).astype(np.float32))
            c.wait_all()
        assert front.table.handshakes_ok == 4
        assert len(c.results) == 12
        assert all(len(st) == 8 for st, _, _ in c.results.values())
        wait_for(lambda: front.table.stats()["parked"] == 4, timeout_s=10.0)
        c.submit(1, rng.normal(size=(2, DIM)).astype(np.float32))
        c.wait_all()
        assert front.table.handshakes_ok == 4
        roster2 = ServingRoster(member=np.r_[True, np.zeros(1, bool),
                                             np.ones(N - 2, bool)],
                                generation=np.zeros(N, np.int64))
        event = front.swap(roster=roster2)
        assert event["sessions_evicted"] == 1
        parsed = front.rows_parsed
        c._send(mux.pack_submit(1, 99, c.sessions[1].token,
                                np.zeros((2, DIM), np.float32)))
        _wait_reject(c, mux.REJ_BAD_STATE)
        assert front.rows_parsed == parsed
    finally:
        if c is not None:
            c.close()
        h.stop()


def test_session_table_matches_reference():
    """The session table's parking and roster eviction under one injected
    clock: the same active, parked and evicted sets as the JAX table."""
    tables = [SessionTable(park_after_s=0.5), JaxSessionTable(
        park_after_s=0.5)]
    rng = np.random.default_rng(5)
    member = np.ones(64, bool)
    generation = np.zeros(64, np.int64)
    now = 0.0
    for step in range(200):
        now += float(rng.exponential(0.05))
        gid = int(rng.integers(0, 64))
        for t in tables:
            s = t.lookup(gid) or t.establish(gid, int(generation[gid]), 0,
                                             now=now)
            t.touch(s, now)
        if step % 17 == 0:
            assert tables[0].park_idle(now) == tables[1].park_idle(now)
        if step % 50 == 49:
            member[rng.integers(0, 64, 3)] = False
            generation[rng.integers(0, 64, 2)] += 1
            assert tables[0].evict_generation(member, generation) == \
                tables[1].evict_generation(member, generation)
        assert tables[0].active == tables[1].active
        assert set(tables[0].sessions) == set(tables[1].sessions)
    assert tables[0].stats() == tables[1].stats()


# -------------------- scoring equivalence through the stripe ------------ #

def test_frontend_striped_scoring_bit_identical_to_direct_router():
    seed, reps, mb = 7, 2, 32
    rng = np.random.default_rng(99)
    rows = rng.normal(size=(48, DIM)).astype(np.float32)
    gid = 5
    direct = Router(build_synthetic_replicas(
        n_gateways=N, dim=DIM, replicas=reps, max_batch=mb, seed=seed,
        model_type="autoencoder", device="cpu"))
    res = direct.submit_many(rows, np.int32(gid))
    direct.drain()
    assert res.finalize()
    front = _small_front(replicas=reps, max_batch=mb, seed=seed,
                         calibrate=False, isolation_on=False)
    h = FrontendHandle(front)
    c = None
    try:
        c = GatewayClient("127.0.0.1", h.port,
                          master=auth.master_key(seed=seed), timeout_s=20.0)
        assert c.authenticate(gid)
        seq = c.submit(gid, rows)
        c.wait_all()
        statuses, scores, _ = c.results[(gid, seq)]
        np.testing.assert_array_equal(statuses, res.statuses)
        np.testing.assert_array_equal(scores.view(np.int32),
                                      res.scores.view(np.int32))
    finally:
        if c is not None:
            c.close()
        h.stop()


def _jax_init_fleet(params, train_x, n_replicas, mb, package):
    if package == "port":
        engines = [port_engine("autoencoder", params, None, mb)
                   for _ in range(n_replicas)]
        return make_local_replicas(lambda i: engines[i], n_replicas,
                                   max_batch=mb, latency_budget_ms=5.0)
    from fedmse_tpu.models import make_model as jax_make_model
    jm = jax_make_model("autoencoder", DIM, shrink_lambda=1.0)
    engines = [JaxEngine.from_federation(jm, "autoencoder", params,
                                         max_bucket=mb)
               for _ in range(n_replicas)]
    return jax_replicas(lambda i: engines[i], n_replicas, max_batch=mb,
                        latency_budget_ms=5.0)


def test_jax_gateway_client_against_port_frontend():
    """The JAX GatewayClient authenticates against the port's frontend,
    whose fleet is built from the JAX init: its verdicts and scores are a
    direct port Router's over the same fleet bit for bit, the JAX plane's
    statuses exactly and its scores to 1e-5; every reject path (unknown
    gateway, bad MAC, bad token) parses no row byte."""
    params = jax_params("autoencoder", 3, n=N)
    rng = np.random.default_rng(8)
    gids = [0, 5, 9, 15]
    bursts = {g: rng.normal(size=(40, DIM)).astype(np.float32)
              for g in gids}
    want = {}
    for package, router_cls in (("port", Router), ("jax", JaxRouter)):
        direct = router_cls(_jax_init_fleet(params, None, 2, 32, package))
        out = {}
        for g in gids:
            res = direct.submit_many(bursts[g], np.int32(g))
            direct.drain()
            assert res.finalize()
            out[g] = (res.statuses.copy(), res.scores.copy())
        want[package] = out
    roster = ServingRoster(member=np.ones(N, bool),
                           generation=np.zeros(N, np.int64))
    roster.member[11] = False
    front = GatewayFrontend(_jax_init_fleet(params, None, 2, 32, "port"),
                            roster, master=auth.master_key(seed=3))
    h = FrontendHandle(front)
    c = bad = None
    try:
        c = JaxGatewayClient("127.0.0.1", h.port,
                             master=jauth.master_key(seed=3),
                             timeout_s=20.0)
        assert c.authenticate_many(gids) == len(gids)
        seqs = {g: c.submit(g, bursts[g]) for g in gids}
        c.wait_all()
        for g in gids:
            st, sc, _ = c.results[(g, seqs[g])]
            np.testing.assert_array_equal(st, want["port"][g][0])
            np.testing.assert_array_equal(sc.view(np.int32),
                                          want["port"][g][1].view(np.int32))
            np.testing.assert_array_equal(st, want["jax"][g][0])
            np.testing.assert_allclose(sc, want["jax"][g][1], atol=1e-5)
        parsed = front.rows_parsed
        assert parsed == 40 * len(gids)
        assert not c.authenticate(11)              # retired slot
        assert not c.authenticate(N + 3)           # outside the roster
        bad = JaxGatewayClient("127.0.0.1", h.port,
                               key_fn=lambda g, gen: b"\x01" * 32,
                               timeout_s=20.0)
        assert not bad.authenticate(2)
        c._send(jmux.pack_submit(5, 77, b"\x00" * jmux.TOKEN_LEN,
                                 bursts[5][:4]))
        _wait_reject(c, jmux.REJ_BAD_TOKEN)
        assert front.rows_parsed == parsed
        assert front.rejects["unknown_gateway"] == 2
        assert front.rejects["bad_mac"] == 1
        assert front.rejects["bad_token"] == 1
    finally:
        for cl in (c, bad):
            if cl is not None:
                cl.close()
        h.stop()


def test_stripe_failover_zero_admitted_ticket_loss():
    reps = build_synthetic_replicas(n_gateways=N, dim=DIM, replicas=2,
                                    max_batch=16, seed=1,
                                    model_type="autoencoder", device="cpu")

    class Dying:
        def __init__(self, inner):
            self.inner = inner
            self.dead = False

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def poll(self):
            if self.dead:
                raise RuntimeError("replica killed mid-flight")
            return self.inner.poll()

    dying = Dying(reps[0])
    stripe = FailoverStripe([dying, reps[1]])
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(64, DIM)).astype(np.float32)
    blk = stripe.submit_many(rows, np.full(64, 3, np.int32))
    dying.dead = True
    deadline = time.time() + 30
    while not blk.done:
        stripe.poll()
        assert time.time() < deadline
    st = stripe.stats()
    assert len(st["failover_events"]) >= 1 and st["alive"] == 1
    assert st["rows_resubmitted"] > 0
    assert len(blk.scores) == 64 and np.isfinite(blk.scores).all()
    np.testing.assert_allclose(
        blk.scores, reps[1].engine.score(rows, np.full(64, 3, np.int32)),
        atol=1e-5)


# ------------------------- isolation (shed storm) ----------------------- #

def test_session_isolation_caps_flooder_not_honest():
    t = [0.0]
    iso = SessionIsolation(capacity_rows_per_sec=1000.0, session_share=0.1,
                           clock=lambda: t[0])
    roster = ServingRoster(member=np.ones(4, bool),
                           generation=np.zeros(4, np.int64))
    router = Router([InstantReplica(4)], roster=roster, isolation=iso,
                    clock=lambda: t[0])
    rows = np.zeros((500, DIM), np.float32)
    res = router.submit_many(rows, np.int32(1), session_key=1)
    res.finalize()
    flood_shed = int((res.statuses == wire.STATUS_SHED).sum())
    assert flood_shed >= 400
    assert router.rows_isolated == flood_shed
    res2 = router.submit_many(rows[:10], np.int32(2), session_key=2)
    res2.finalize()
    assert int((res2.statuses == wire.STATUS_SHED).sum()) == 0


# ------------------------ two-class autoscale sizing --------------------- #

def test_plan_split_sizes_frontends_and_replicas_independently():
    fe = FrontendSpec(max_sessions=200_000, handshakes_per_sec=3000.0,
                      mux_rows_per_sec=500_000.0, usd_per_hour=0.05)
    be = [BackendSpec("cpu", rows_per_sec=50_000.0, usd_per_hour=0.10)]
    p = plan_split(demand_rows_per_sec=1000.0, concurrent_sessions=1e6,
                   handshake_rate_per_sec=100.0, frontend=fe, backends=be)
    assert p["frontend_axis"] == "sessions"
    assert p["frontends"] == 9
    assert p["replicas"] == {"cpu": 1}
    q = plan_split(demand_rows_per_sec=120_000.0, concurrent_sessions=500,
                   handshake_rate_per_sec=10.0, frontend=fe, backends=be)
    assert q["frontends"] == 1 and q["replicas"]["cpu"] == 4
    assert q["frontend_axis"] == "mux_rows"
    assert q["usd_per_hour"] == pytest.approx(
        q["frontend_usd_per_hour"] + q["replica_usd_per_hour"])
    # the same plans as the JAX package over a grid, defaults included
    jfe, jbe = JaxFrontendSpec(), [JaxBackend("cpu", 50_000.0, 0.10)]
    rng = np.random.default_rng(0)
    for _ in range(50):
        args = dict(demand_rows_per_sec=float(rng.uniform(0, 2e6)),
                    concurrent_sessions=float(rng.uniform(0, 5e6)),
                    handshake_rate_per_sec=float(rng.uniform(0, 2e4)))
        assert plan_split(frontend=FrontendSpec(), backends=be, **args) == \
            jax_plan_split(frontend=jfe, backends=jbe, **args)


def test_scale_down_requires_confirmation_ticks():
    t = [0.0]
    sc = SLOAutoscaler(budget_ms=25.0,
                       backends=[BackendSpec("cpu", rows_per_sec=10_000.0,
                                             usd_per_hour=0.1)],
                       cooldown_s=0.0, scale_down_confirm_ticks=3,
                       clock=lambda: t[0])
    cur = {"cpu": 4}

    def tick(arrival):
        t[0] += 1.0
        return sc.decide(arrival_rows_per_sec=arrival, p99_ms=None,
                         current=cur)

    assert tick(500.0).action == "hold"
    assert tick(500.0).action == "hold"
    assert "confirmation" in sc.decisions[-1].reason
    assert tick(30_000.0).action == "scale_up"
    cur = {"cpu": 5}
    assert tick(500.0).action == "hold"
    assert tick(500.0).action == "hold"
    d = tick(500.0)
    assert d.action == "scale_down" and d.replicas == {"cpu": 1}


def test_gateway_fields_are_the_frontends_defaults_not_main_flags():
    """A training run (main.py) starts no gateway: no --gateway-* flag of
    its is accepted and ignored; the frontend's entry takes the fields as
    its defaults."""
    import argparse

    from fedmse_tpu_torch.config import (GATEWAY_FIELDS, ExperimentConfig,
                                         add_cli_overrides)
    from fedmse_tpu_torch.gateway.frontend import _parser
    assert len(GATEWAY_FIELDS) == 7
    training = argparse.ArgumentParser()
    add_cli_overrides(training)
    for name in GATEWAY_FIELDS:
        _, rest = training.parse_known_args(["--" + name.replace("_", "-"),
                                           "1"])
        assert rest[0] == "--" + name.replace("_", "-")
    cfg = ExperimentConfig()
    args = _parser().parse_args([])
    assert (args.port, args.master_key_hex, args.session_share, args.park_s,
            args.max_sessions_per_conn) == (
        cfg.gateway_port, cfg.gateway_master_key_hex,
        cfg.gateway_session_share, cfg.gateway_park_s,
        cfg.gateway_sessions_per_conn)
