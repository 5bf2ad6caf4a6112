"""The ingest frontend: auth + admission in front of scoring replicas (port
of fedmse_tpu/gateway/frontend.py).

One frontend process is a single-threaded `selectors` (epoll) loop
holding tens of thousands of gateway sessions on a few thousand TCP
connections (mux.py: sessions multiplex over connections, so the fleet
scale is bounded by the session table, not the process fd limit). The
loop does exactly the cheap work — handshakes, token checks, framing —
and stripes every ADMITTED burst to scoring replicas through a
`FailoverStripe` behind a literal net-plane `Router`, which is what
keeps roster-aware routing and SHED-verdict semantics the net plane's
code rather than a re-implementation:

    conn -> G_SUBMIT -> session/token check -> Router([stripe],
        admission=AdmissionController, isolation=SessionIsolation,
        roster=...) -> member replicas (LocalReplica in-process, or
        RemoteReplica worker processes) -> G_RESULT

Security order of operations (the tested pin):

  1. G_HELLO carries (gateway_id, generation): the ROSTER check runs
     here — an unknown / retired / generation-mismatched slot gets
     G_REJECT(UNKNOWN_GATEWAY) and the plane never parses a row byte
     from it (`rows_parsed` counts rows whose bytes were interpreted;
     tests pin it at 0 across every reject path).
  2. G_AUTH proves key possession (auth.py HMAC over the transcript)
     before a session exists.
  3. Every G_SUBMIT's bearer token is checked (constant-time) BEFORE
     `unpack_submit_rows` touches the row block — mux.py puts the token
     ahead of the rows in the frame for exactly this read order.
  4. Admitted rows flow through per-session isolation, then the shared
     tiered bucket, then the stripe — every row still gets exactly one
     terminal status (the net plane's contract, unchanged).

TLS is optional and composes underneath (tls.py): the same loop drives
non-blocking TLS handshakes off the selector before any gateway frame
is read.

`FrontendHandle` runs a frontend on its own thread (tests, chip_smoke.py);
every dispatch and harvest of its local replicas is then issued from that
thread, on each replica's own CUDA stream (net/router.py).
`python -m fedmse_tpu_torch.gateway.frontend [--device cpu]` is the
process entry of a multi-frontend topology.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import ssl
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from fedmse_tpu_torch.gateway import auth, mux
from fedmse_tpu_torch.gateway.session import PendingHandshake, SessionTable
from fedmse_tpu_torch.gateway.stripe import FailoverStripe
from fedmse_tpu_torch.net import wire
from fedmse_tpu_torch.net.router import Router
from fedmse_tpu_torch.net.server import _json_safe

logger = logging.getLogger(__name__)

_READ = selectors.EVENT_READ
_WRITE = selectors.EVENT_WRITE
_RECV_CHUNK = 1 << 18
_OUT_COMPACT_AT = 1 << 16


class _GwConn:
    """One accepted connection's state."""

    __slots__ = ("sock", "conn_id", "is_tls", "tls_pending", "fb", "out",
                 "out_off", "sessions", "pending_hs", "pending_results",
                 "strikes", "mask", "closed", "close_after_flush")

    def __init__(self, sock, conn_id: int, is_tls: bool):
        self.sock = sock
        self.conn_id = conn_id
        self.is_tls = is_tls
        self.tls_pending = False
        self.fb = wire.FrameBuffer()
        self.out = bytearray()
        self.out_off = 0
        self.sessions: set = set()          # gateway ids owned here
        self.pending_hs: Dict[int, PendingHandshake] = {}
        self.pending_results: deque = deque()   # (gid, seq, session, res)
        self.strikes = 0
        self.mask = _READ
        self.closed = False
        self.close_after_flush = False


class GatewayFrontend:
    """The secure multiplexed ingest plane's front process (module doc).

    `replicas` is a list of replica-shaped members (LocalReplica /
    RemoteReplica) or an already-built FailoverStripe; the frontend
    always routes through a stripe so member death never strands an
    admitted ticket. `roster` is mandatory — this plane exists to check
    identity, and the handshake needs something to check against."""

    def __init__(self, replicas, roster, master: bytes,
                 host: str = "127.0.0.1", port: int = 0,
                 admission=None, isolation=None,
                 tls_context: Optional[ssl.SSLContext] = None,
                 resubmit_after_s: Optional[float] = None,
                 park_after_s: float = 1.0,
                 max_sessions_per_conn: int = 64,
                 preauth_strikes: int = 8,
                 autoscaler=None,
                 replica_factory: Optional[Callable[[int], object]] = None,
                 backend_name: str = "cpu",
                 autoscale_interval_s: float = 1.0,
                 name: str = "frontend",
                 clock: Callable[[], float] = time.perf_counter):
        if roster is None:
            raise ValueError("the gateway frontend requires a roster: "
                             "handshake identity is checked against it")
        self.stripe = (replicas if isinstance(replicas, FailoverStripe)
                       else FailoverStripe(replicas, name=f"{name}-stripe",
                                           resubmit_after_s=resubmit_after_s,
                                           clock=clock))
        self.router = Router([self.stripe], roster=roster,
                             admission=admission, isolation=isolation,
                             clock=clock)
        self.master = master
        self.host = host
        self.port = port              # 0 = ephemeral; real after start()
        self.tls_context = tls_context
        self.table = SessionTable(park_after_s=park_after_s, clock=clock)
        self.max_sessions_per_conn = max_sessions_per_conn
        self.preauth_strikes = preauth_strikes
        self.autoscaler = autoscaler
        self.replica_factory = replica_factory
        self.backend_name = backend_name
        self.autoscale_interval_s = autoscale_interval_s
        self.name = name
        self.clock = clock

        self.sel = selectors.DefaultSelector()
        self.lsock: Optional[socket.socket] = None
        self._conns: List[_GwConn] = []
        self._conn_by_id: Dict[int, _GwConn] = {}
        self._next_conn_id = 1
        self._next_park = 0.0
        self._next_scale = 0.0
        self.inflight_results = 0

        self.conns_accepted = 0
        self.hellos = 0
        self.rows_parsed = 0        # rows whose BYTES were interpreted —
        self.results_sent = 0       # the pre-parse rejection pin
        self.rejects = {name: 0 for name in mux.REJ_NAMES.values()}
        self.autoscale_events: List[Dict] = []

    # ----------------------------- lifecycle ------------------------------ #

    def start(self) -> None:
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((self.host, self.port))
        self.port = self.lsock.getsockname()[1]
        self.lsock.listen(4096)
        self.lsock.setblocking(False)
        self.sel.register(self.lsock, _READ, None)
        now = self.clock()
        self._next_park = now + self.table.park_after_s / 2
        self._next_scale = now + self.autoscale_interval_s
        logger.info("gateway frontend %s listening on %s:%d (tls=%s, "
                    "%d stripe member(s))", self.name, self.host, self.port,
                    self.tls_context is not None, len(self.stripe.members))

    def close(self) -> None:
        if self.lsock is not None:
            try:
                self.sel.unregister(self.lsock)
            except (KeyError, ValueError):
                pass
            self.lsock.close()
            self.lsock = None
        for conn in list(self._conns):
            self._close(conn)
        self.sel.close()

    def serve(self, stop: Optional[threading.Event] = None) -> None:
        while stop is None or not stop.is_set():
            self.step(0.0005 if self.inflight_results else 0.02)

    # ------------------------------ the loop ------------------------------ #

    def step(self, timeout: float = 0.0) -> bool:
        """One loop iteration: socket events, replica harvests, result
        flushes, periodic parking/scaling. Returns whether it did work."""
        events = self.sel.select(timeout)
        for key, mask in events:
            conn = key.data
            if conn is None:
                self._accept()
                continue
            if conn.tls_pending:
                self._tls_step(conn)
                continue
            if mask & _READ:
                self._read(conn)
            if mask & _WRITE and not conn.closed:
                self._flush_out(conn)
        busy = self.router.poll()
        sent = self._flush_completed()
        now = self.clock()
        if now >= self._next_park:
            self._next_park = now + self.table.park_after_s / 2
            self.table.park_idle(now)
        if self.autoscaler is not None and now >= self._next_scale:
            self._next_scale = now + self.autoscale_interval_s
            self._autoscale_tick()
        return bool(events) or busy or bool(sent)

    # ---------------------------- connections ----------------------------- #

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self.lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            self.conns_accepted += 1
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            is_tls = self.tls_context is not None
            if is_tls:
                try:
                    sock = self.tls_context.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False)
                except (ssl.SSLError, OSError):
                    sock.close()
                    continue
            conn = _GwConn(sock, self._next_conn_id, is_tls)
            self._next_conn_id += 1
            self._conns.append(conn)
            self._conn_by_id[conn.conn_id] = conn
            self.sel.register(sock, _READ, conn)
            if is_tls:
                conn.tls_pending = True
                self._tls_step(conn)

    def _tls_step(self, conn: _GwConn) -> None:
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._set_mask(conn, _READ)
            return
        except ssl.SSLWantWriteError:
            self._set_mask(conn, _READ | _WRITE)
            return
        except (ssl.SSLError, ConnectionError, OSError):
            self._close(conn)
            return
        conn.tls_pending = False
        self._set_mask(conn, _READ)
        self._read(conn)  # records may already be decrypt-buffered

    def _set_mask(self, conn: _GwConn, mask: int) -> None:
        if conn.closed or mask == conn.mask:
            return
        try:
            self.sel.modify(conn.sock, mask, conn)
            conn.mask = mask
        except (KeyError, ValueError, OSError):
            self._close(conn)

    def _close(self, conn: _GwConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        try:
            self._conns.remove(conn)
        except ValueError:
            pass
        self._conn_by_id.pop(conn.conn_id, None)
        for gid in conn.sessions:
            s = self.table.lookup(gid)
            if s is not None and s.conn_id == conn.conn_id:
                self.table.drop(gid)
        # in-flight tickets still complete inside the replicas (never
        # dropped); only the responses have nowhere to go
        self.inflight_results -= len(conn.pending_results)
        conn.pending_results.clear()

    # ------------------------------- reads -------------------------------- #

    def _read(self, conn: _GwConn) -> None:
        try:
            while True:
                data = conn.sock.recv(_RECV_CHUNK)
                if not data:
                    self._close(conn)
                    return
                conn.fb.feed(data)
                if len(data) < _RECV_CHUNK and not (
                        conn.is_tls and conn.sock.pending()):
                    break
        except (BlockingIOError, InterruptedError, ssl.SSLWantReadError):
            pass
        except (ConnectionError, OSError, ssl.SSLError):
            self._close(conn)
            return
        try:
            for payload in conn.fb.frames():
                self._on_frame(conn, payload)
                if conn.closed:
                    return
        except wire.WireError as e:
            self._send(conn, mux.pack_simple(mux.G_ERROR,
                                             body=str(e).encode()))
            conn.close_after_flush = True
            self._flush_out(conn)

    def _on_frame(self, conn: _GwConn, payload: memoryview) -> None:
        mt, _, gid, seq = mux.parse_gheader(payload)
        if mt == mux.G_SUBMIT:            # hot path first
            self._on_submit(conn, gid, payload)
        elif mt == mux.G_HELLO:
            self._on_hello(conn, payload)
        elif mt == mux.G_AUTH:
            self._on_auth(conn, payload)
        elif mt == mux.G_PING:
            # keepalive: answered, but does NOT unpark the session — a
            # parked gateway pinging stays off the active set
            self._send(conn, mux.pack_simple(mux.G_PONG, gid, seq))
        elif mt == mux.G_BYE:
            self._drop_session(conn, gid)
        elif mt == mux.G_STATS:
            body = json.dumps(_json_safe(self.stats())).encode()
            self._send(conn, mux.pack_simple(mux.G_STATS_REPLY, body=body))
        elif mt == mux.G_ERROR:
            self._close(conn)
        else:
            self._send(conn, mux.pack_simple(
                mux.G_ERROR, body=f"unknown msg_type {mt}".encode()))
            conn.close_after_flush = True
            self._flush_out(conn)

    # ----------------------------- handshake ------------------------------ #

    def _roster_ok(self, gid: int, generation: int) -> bool:
        r = self.router.roster
        return (0 <= gid < len(r.member) and bool(r.member[gid])
                and int(r.generation[gid]) == generation)

    def _reject(self, conn: _GwConn, gid: int, code: int,
                detail: str = "") -> None:
        self.rejects[mux.REJ_NAMES[code]] += 1
        self._send(conn, mux.pack_reject(gid, code, detail))
        if not conn.sessions:
            # unauthenticated peers accumulate strikes; past the budget
            # the connection goes (an authenticated concentrator with a
            # few bad tenants among its pipelined handshakes survives)
            conn.strikes += 1
            if conn.strikes >= self.preauth_strikes:
                conn.close_after_flush = True
                self._flush_out(conn)

    def _on_hello(self, conn: _GwConn, payload: memoryview) -> None:
        gid, generation, client_nonce = mux.unpack_hello(payload)
        self.hellos += 1
        if (len(conn.sessions) + len(conn.pending_hs)
                >= self.max_sessions_per_conn):
            self._reject(conn, gid, mux.REJ_OVER_SESSION_CAP,
                         f"connection session budget "
                         f"{self.max_sessions_per_conn}")
            return
        if not self._roster_ok(gid, generation):
            # THE handshake-time roster gate: terminal before any row
            # bytes from this identity exist anywhere in the process
            self._reject(conn, gid, mux.REJ_UNKNOWN_GATEWAY,
                         "not in the roster at this generation")
            return
        server_nonce = auth.new_nonce()
        conn.pending_hs[gid] = PendingHandshake(
            gid, generation, client_nonce, server_nonce, self.clock())
        self._send(conn, mux.pack_challenge(gid, server_nonce))

    def _on_auth(self, conn: _GwConn, payload: memoryview) -> None:
        gid, mac = mux.unpack_auth(payload)
        hs = conn.pending_hs.pop(gid, None)
        if hs is None:
            self._reject(conn, gid, mux.REJ_BAD_STATE,
                         "no handshake in progress")
            return
        key = auth.gateway_key(self.master, gid, hs.generation)
        if not auth.verify_session_mac(key, gid, hs.generation,
                                       hs.client_nonce, hs.server_nonce,
                                       mac):
            self._reject(conn, gid, mux.REJ_BAD_MAC)
            return
        if not self._roster_ok(gid, hs.generation):
            # roster swapped between HELLO and AUTH: same terminal gate
            self._reject(conn, gid, mux.REJ_UNKNOWN_GATEWAY,
                         "roster changed during handshake")
            return
        now = self.clock()
        prev = self.table.lookup(gid)
        if prev is not None and prev.conn_id != conn.conn_id:
            # reconnect supersedes: the old connection's claim dies
            old = self._conn_by_id.get(prev.conn_id)
            if old is not None:
                old.sessions.discard(gid)
        s = self.table.establish(gid, hs.generation, conn.conn_id, now)
        self.table.touch(s, now)
        conn.sessions.add(gid)
        self._send(conn, mux.pack_welcome(gid, s.token))

    def _drop_session(self, conn: _GwConn, gid: int) -> None:
        s = self.table.lookup(gid)
        if s is not None and s.conn_id == conn.conn_id:
            self.table.drop(gid)
        conn.sessions.discard(gid)

    # ------------------------------ traffic ------------------------------- #

    def _on_submit(self, conn: _GwConn, gid: int,
                   payload: memoryview) -> None:
        s = self.table.lookup(gid)
        if s is None or s.conn_id != conn.conn_id:
            self._reject(conn, gid, mux.REJ_BAD_STATE,
                         "no session on this connection")
            return
        if not s.check_token(mux.submit_token(payload)):
            self._reject(conn, gid, mux.REJ_BAD_TOKEN)
            return
        # verification passed — only now do the row bytes get parsed
        seq, rows, tier, t_sent = mux.unpack_submit_rows(payload)
        n = rows.shape[0]
        self.rows_parsed += n
        s.rows_offered += n
        if seq > s.seq_seen:
            s.seq_seen = seq
        self.table.touch(s, self.clock())
        # age = peer clock skew + kernel RX + reader backlog; clamp at 0
        age = max(0.0, time.time() - t_sent)
        res = self.router.submit_many(rows, np.int32(gid), tier,
                                      age_s=age, session_key=gid)
        conn.pending_results.append((gid, seq, s, res))
        s.pending += 1
        self.inflight_results += 1

    def _flush_completed(self) -> int:
        sent = 0
        for conn in list(self._conns):
            q = conn.pending_results
            while q:
                gid, seq, s, res = q[0]
                if not res.finalize():
                    break
                q.popleft()
                self.inflight_results -= 1
                s.pending -= 1
                st = res.statuses
                s.rows_admitted += int((st < wire.STATUS_SHED).sum())
                s.rows_shed += int((st == wire.STATUS_SHED).sum())
                self._send(conn, mux.pack_result(gid, seq, st, res.scores))
                if conn.closed:
                    break
                sent += 1
                self.results_sent += 1
        return sent

    # ------------------------------- writes ------------------------------- #

    def _send(self, conn: _GwConn, frame: bytes) -> None:
        if conn.closed:
            return
        conn.out += frame
        self._flush_out(conn)

    def _flush_out(self, conn: _GwConn) -> None:
        try:
            while conn.out_off < len(conn.out):
                k = conn.sock.send(memoryview(conn.out)[conn.out_off:])
                if k <= 0:
                    break
                conn.out_off += k
        except (BlockingIOError, InterruptedError, ssl.SSLWantWriteError,
                ssl.SSLWantReadError):
            pass
        except (ConnectionError, OSError, ssl.SSLError):
            self._close(conn)
            return
        if conn.out_off >= len(conn.out):
            conn.out.clear()
            conn.out_off = 0
            if conn.close_after_flush:
                self._close(conn)
                return
            self._set_mask(conn, _READ)
        else:
            if conn.out_off > _OUT_COMPACT_AT:
                del conn.out[:conn.out_off]
                conn.out_off = 0
            self._set_mask(conn, _READ | _WRITE)

    # ---------------------------- control plane --------------------------- #

    def swap(self, **payload) -> Dict:
        """Broadcast one atomic payload through the stripe; a roster
        change additionally EVICTS sessions whose slot was retired or
        re-tenanted (their credentials are stale by construction)."""
        event = self.router.swap(**payload)
        roster = payload.get("roster")
        if roster is not None:
            event["sessions_evicted"] = self.table.evict_generation(
                roster.member, roster.generation)
        return event

    def calibrate_capacity(self, probe_rows: np.ndarray,
                           probe_gws: np.ndarray, reps: int = 5) -> float:
        """Probe the stripe MEMBERS' engines (the stripe itself carries
        no engine) and install the measured fleet capacity in the shared
        admission bucket + the per-session isolation gate."""
        members = [m for m, a in zip(self.stripe.members, self.stripe.alive)
                   if a and getattr(m, "engine", None) is not None]
        if not members:
            raise ValueError("no in-process member engines to probe; set "
                             "capacity explicitly for remote-worker fleets")
        probe_router = Router(members, roster=self.router.roster,
                              admission=self.router.admission)
        total = probe_router.calibrate_capacity(probe_rows, probe_gws,
                                                reps=reps)
        if self.router.isolation is not None:
            self.router.isolation.set_capacity(total)
        return total

    def set_capacity(self, rows_per_sec: float) -> None:
        """Remote-worker fleets: install an externally measured (or
        worker-calibrated) capacity in admission + isolation."""
        if self.router.admission is not None:
            self.router.admission.set_capacity(rows_per_sec)
        if self.router.isolation is not None:
            self.router.isolation.set_capacity(rows_per_sec)

    def _autoscale_tick(self) -> None:
        """Replica-count live apply THROUGH the stripe — the same
        single-backend discipline as NetFront._autoscale_tick, with
        membership changes going through FailoverStripe.add_member /
        remove_member so scale-down drains and scale-up enters the
        rotation immediately."""
        adm = self.router.admission
        arrival = (adm.arrival_rate_rows_per_sec
                   if adm is not None else 0.0)
        sst = self.stripe.stats()
        n_before = self.stripe.n_alive
        d = self.autoscaler.decide(
            arrival_rows_per_sec=arrival,
            p99_ms=sst["latency_p99_ms"],
            current={self.backend_name: n_before})
        if d.action == "hold":
            return
        applied = {"action": d.action, "reason": d.reason,
                   "bucket": d.bucket, "decided_mix": dict(d.replicas)}
        want = d.replicas.get(self.backend_name, n_before)
        if self.replica_factory is not None:
            while self.stripe.n_alive < want:
                self.stripe.add_member(
                    self.replica_factory(len(self.stripe.members)))
            while self.stripe.n_alive > max(1, want):
                self.stripe.remove_member()
        self.stripe.resize(d.bucket)
        if adm is not None and adm.capacity_rows_per_sec is not None:
            adm.set_capacity(adm.capacity_rows_per_sec
                             * self.stripe.n_alive / max(1, n_before))
            if self.router.isolation is not None:
                self.router.isolation.set_capacity(
                    adm.capacity_rows_per_sec)
        self.autoscaler.mark_applied()
        applied["replicas_now"] = self.stripe.n_alive
        self.autoscale_events.append(applied)
        logger.info("gateway autoscale: %s", applied)

    # ----------------------------- telemetry ------------------------------ #

    def stats(self) -> Dict:
        out = {
            "front": "gateway", "name": self.name,
            "host": self.host, "port": self.port,
            "tls": self.tls_context is not None,
            "conns_open": len(self._conns),
            "conns_accepted": self.conns_accepted,
            "hellos": self.hellos,
            "rows_parsed": self.rows_parsed,
            "results_sent": self.results_sent,
            "inflight_results": self.inflight_results,
            "rejects": dict(self.rejects),
            "sessions": self.table.stats(),
            "router": self.router.stats(),
            "stripe": self.stripe.stats(),
            "autoscale_events": self.autoscale_events,
        }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out


class FrontendHandle:
    """A GatewayFrontend running on its own thread (tests, chip_smoke.py):
    `port` is live after construction, `stop()` joins cleanly."""

    def __init__(self, frontend: GatewayFrontend):
        self.frontend = frontend
        frontend.start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=frontend.name)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.frontend.port

    def _run(self) -> None:
        try:
            self.frontend.serve(self._stop)
        finally:
            self.frontend.close()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(30.0)


# --------------------------- process entry ----------------------------- #

def build_synthetic_frontend(n_gateways: int = 1024, dim: int = 115,
                             replicas: int = 1, max_batch: int = 1024,
                             latency_budget_ms: float = 25.0,
                             tiers: int = 3, headroom: float = 0.9,
                             seed: int = 0, model_type: str = "hybrid",
                             session_share: float = 0.25,
                             isolation_on: bool = True,
                             calibrate: bool = True,
                             tls_context=None, warmup: bool = True,
                             return_factory: bool = False,
                             device="cuda",
                             **frontend_kw) -> GatewayFrontend:
    """A self-contained gateway frontend over the synthetic deployment
    (net.server.build_synthetic_replicas — the SAME scoring fleet the
    net plane builds from this seed, so verdicts are bit-comparable)."""
    from fedmse_tpu_torch.net.admission import (AdmissionController,
                                          SessionIsolation)
    from fedmse_tpu_torch.net.server import build_synthetic_replicas
    from fedmse_tpu_torch.serving.engine import ServingRoster

    built = build_synthetic_replicas(
        n_gateways=n_gateways, dim=dim, replicas=replicas,
        max_batch=max_batch, latency_budget_ms=latency_budget_ms,
        seed=seed, model_type=model_type, warmup=warmup,
        return_factory=return_factory, device=device)
    local, replica_factory = built if return_factory else (built, None)
    roster = ServingRoster(member=np.ones(n_gateways, bool),
                           generation=np.zeros(n_gateways, np.int64))
    front = GatewayFrontend(
        local, roster, master=auth.master_key(seed=seed),
        admission=AdmissionController(
            tiers=tiers, headroom=headroom,
            stale_after_s=latency_budget_ms / 1000.0),
        isolation=(SessionIsolation(session_share=session_share)
                   if isolation_on else None),
        tls_context=tls_context,
        replica_factory=replica_factory,
        **frontend_kw)
    if calibrate:
        rng = np.random.default_rng(seed + 1)
        probe = rng.normal(size=(max_batch, dim)).astype(np.float32)
        probe_g = rng.integers(0, n_gateways, max_batch).astype(np.int32)
        front.calibrate_capacity(probe, probe_g)
    return front


def _parser():
    """The frontend entry's flags; the gateway plane's settings default to
    ExperimentConfig's gateway_* fields."""
    import argparse

    from fedmse_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=cfg.gateway_port)
    p.add_argument("--gateways", type=int, default=1024)
    p.add_argument("--dim", type=int, default=115)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernels) or cpu (their "
                        "plain PyTorch versions) for the local replicas")
    p.add_argument("--master-key-hex", default=cfg.gateway_master_key_hex,
                   help="fleet master secret (hex); default: the "
                        "seed-derived DEV key (benches/tests only)")
    p.add_argument("--replica-addr", action="append", default=[],
                   metavar="HOST:PORT",
                   help="a net-plane replica worker to stripe over "
                        "(repeat); default: in-process local replicas")
    p.add_argument("--local-replicas", type=int, default=1)
    p.add_argument("--max-batch", type=int, default=1024)
    p.add_argument("--budget-ms", type=float, default=25.0)
    p.add_argument("--tiers", type=int, default=3)
    p.add_argument("--headroom", type=float, default=0.9)
    p.add_argument("--model-type", default="hybrid")
    p.add_argument("--no-admission", action="store_true")
    p.add_argument("--no-isolation", action="store_true")
    p.add_argument("--session-share", type=float,
                   default=cfg.gateway_session_share)
    p.add_argument("--capacity-rows-per-sec", type=float, default=None,
                   help="admission capacity for remote-worker fleets "
                        "(local fleets calibrate by probing)")
    p.add_argument("--tls-dir", default=None,
                   help="serve TLS with the self-signed pair in this "
                        "directory (generated if absent)")
    p.add_argument("--park-s", type=float, default=cfg.gateway_park_s)
    p.add_argument("--max-sessions-per-conn", type=int,
                   default=cfg.gateway_sessions_per_conn)
    p.add_argument("--resubmit-after-s", type=float, default=None)
    return p


def main(argv=None) -> None:
    """Standalone gateway frontend (a multi-frontend topology's process
    entry): local synthetic replicas, or remote net-plane replica workers
    via --replica-addr."""
    import signal

    args = _parser().parse_args(argv)

    tls_ctx = None
    if args.tls_dir:
        from fedmse_tpu_torch.gateway import tls
        cert, key = tls.ensure_self_signed(args.tls_dir)
        tls_ctx = tls.server_context(cert, key)

    master = auth.master_key(args.master_key_hex, seed=args.seed)
    common = dict(host=args.host, port=args.port,
                  tls_context=tls_ctx, park_after_s=args.park_s,
                  max_sessions_per_conn=args.max_sessions_per_conn,
                  resubmit_after_s=args.resubmit_after_s)

    if args.replica_addr:
        from fedmse_tpu_torch.net.admission import (AdmissionController,
                                              SessionIsolation)
        from fedmse_tpu_torch.net.client import RemoteReplica
        from fedmse_tpu_torch.serving.engine import ServingRoster

        members = []
        for addr in args.replica_addr:
            host, _, port = addr.rpartition(":")
            members.append(RemoteReplica(host or "127.0.0.1", int(port),
                                         num_gateways=args.gateways,
                                         max_batch=args.max_batch))
        roster = ServingRoster(member=np.ones(args.gateways, bool),
                               generation=np.zeros(args.gateways, np.int64))
        front = GatewayFrontend(
            members, roster, master=master,
            admission=(None if args.no_admission else AdmissionController(
                tiers=args.tiers, headroom=args.headroom,
                stale_after_s=args.budget_ms / 1000.0)),
            isolation=(None if args.no_isolation else SessionIsolation(
                session_share=args.session_share)),
            **common)
        if args.capacity_rows_per_sec:
            front.set_capacity(args.capacity_rows_per_sec)
    else:
        front = build_synthetic_frontend(
            n_gateways=args.gateways, dim=args.dim,
            replicas=args.local_replicas, max_batch=args.max_batch,
            latency_budget_ms=args.budget_ms, tiers=args.tiers,
            headroom=args.headroom, seed=args.seed,
            model_type=args.model_type,
            session_share=args.session_share,
            isolation_on=not args.no_isolation,
            calibrate=not args.no_admission, device=args.device, **common)
        if args.no_admission:
            front.router.admission = None
        if args.capacity_rows_per_sec:
            front.set_capacity(args.capacity_rows_per_sec)
    if args.master_key_hex == "":
        logger.warning("serving with the seed-derived DEV master key — "
                       "benches/tests only, never production material")

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    front.start()
    print(json.dumps({"listening": True, "host": args.host,
                      "port": front.port,
                      "tls": tls_ctx is not None,
                      "replicas": len(front.stripe.members)}), flush=True)
    try:
        front.serve(stop)
    except KeyboardInterrupt:
        pass
    finally:
        front.close()


if __name__ == "__main__":
    main()
