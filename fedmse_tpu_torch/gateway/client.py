"""Gateway-side client: many authenticated sessions on one connection.

`GatewayClient` is the concentrator shape the mux wire was designed
for — one TCP (optionally TLS) connection to a frontend carrying many
gateway sessions, each individually authenticated (auth.py handshake)
and individually tokened. It is an OPEN-LOOP client like net/client.py
NetClient: `submit()` frames a burst and returns, `poll()` drains
whatever the kernel buffered, `wait_all()` blocks — the load
generator's contract, and the shape of a real edge concentrator firing
NIC batches upstream.

Handshakes PIPELINE: `authenticate_many()` sends a window of G_HELLOs,
answers each G_CHALLENGE as it lands (the MAC is computed client-side
from the per-gateway enrollment key), and resolves on G_WELCOME /
G_REJECT — so establishing thousands of sessions costs round-trips
per WINDOW, not per session. The per-gateway keys derive from the
fleet master exactly as the frontend derives them (the dev/bench
mirror of real per-device provisioning; pass `key_fn` to model a
gateway holding only its own key — or holding the wrong one).

A G_REJECT is terminal for its SESSION: the client drops the session,
fails its outstanding bursts, and records the coded reason (tests and
the red-team harness read `rejects`).
"""

from __future__ import annotations

import select
import socket
import ssl
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fedmse_tpu_torch.gateway import auth, mux
from fedmse_tpu_torch.net import wire


class GatewayClientError(RuntimeError):
    """Protocol violation / timeout / peer-reported G_ERROR."""


def _wait_io(sock, timeout_s: float, write: bool = False) -> None:
    """Block until `sock` is readable (or writable too) or the timeout
    lapses. poll(), not select(): a bench process holding 10k+ client
    connections has fds past FD_SETSIZE, where select() raises."""
    if hasattr(select, "poll"):
        p = select.poll()
        p.register(sock.fileno(),
                   select.POLLIN | (select.POLLOUT if write else 0))
        p.poll(int(timeout_s * 1000))
    else:  # non-poll platforms: the low-fd path
        select.select([sock], [sock] if write else [], [], timeout_s)


class _Sess:
    __slots__ = ("generation", "token", "next_seq")

    def __init__(self, generation: int, token: bytes):
        self.generation = generation
        self.token = token
        self.next_seq = 1


class GatewayClient:
    """One (optionally TLS) connection to a gateway frontend."""

    def __init__(self, host: str, port: int, master: Optional[bytes] = None,
                 key_fn: Optional[Callable[[int, int], bytes]] = None,
                 tls_context: Optional[ssl.SSLContext] = None,
                 timeout_s: float = 30.0):
        if (master is None) == (key_fn is None):
            raise ValueError("pass exactly one of master / key_fn")
        self.key_fn = key_fn or (
            lambda gid, gen: auth.gateway_key(master, gid, gen))
        self.timeout_s = timeout_s
        sock = socket.create_connection((host, port), timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls_context is not None:
            sock = tls_context.wrap_socket(sock, server_hostname=host)
            sock.do_handshake()
        # non-blocking after setup: _flush_out interleaves reads when the
        # send buffer fills (the anti-deadlock half of the open loop)
        sock.setblocking(False)
        self.sock = sock
        self._buf = wire.FrameBuffer()
        self._out = bytearray()
        self._out_off = 0
        self._hs: Dict[int, Tuple[int, bytes]] = {}  # gid -> (gen, cnonce)
        self.sessions: Dict[int, _Sess] = {}
        self.rejects: List[Tuple[int, int, str]] = []  # (gid, code, detail)
        # (gid, seq) -> (n_rows, t_submit); completed -> result tuple
        self.outstanding: Dict[Tuple[int, int], Tuple[int, float]] = {}
        self.results: Dict[Tuple[int, int],
                           Tuple[np.ndarray, np.ndarray, float]] = {}
        self.failed: Dict[Tuple[int, int], int] = {}  # burst -> reject code
        self.rows_submitted = 0
        self.pongs = 0
        self.stats_replies: List[dict] = []

    # ------------------------------ plumbing ------------------------------ #

    def _consume(self) -> int:
        """Parse buffered frames; auto-answers challenges by QUEUEING
        the G_AUTH (never sends from inside the parse — _flush_out
        calls back here while blocked on writes). Returns completed
        result count."""
        done = 0
        for payload in self._buf.frames():
            mt, code, gid, seq = mux.parse_gheader(payload)
            if mt == mux.G_RESULT:
                rgid, rseq, statuses, scores = mux.unpack_result(payload)
                meta = self.outstanding.pop((rgid, rseq), None)
                if meta is None:
                    raise GatewayClientError(
                        f"unknown G_RESULT for ({rgid}, {rseq})")
                n, t0 = meta
                if len(statuses) != n:
                    raise GatewayClientError(
                        f"burst ({rgid}, {rseq}): submitted {n} rows, "
                        f"result carries {len(statuses)}")
                self.results[(rgid, rseq)] = (
                    statuses, scores, time.perf_counter() - t0)
                done += 1
            elif mt == mux.G_CHALLENGE:
                cgid, snonce = mux.unpack_challenge(payload)
                hs = self._hs.get(cgid)
                if hs is None:
                    continue  # a challenge we no longer care about
                gen, cnonce = hs
                mac = auth.session_mac(self.key_fn(cgid, gen), cgid, gen,
                                       cnonce, snonce)
                self._out += mux.pack_auth(cgid, mac)
            elif mt == mux.G_WELCOME:
                wgid, token = mux.unpack_welcome(payload)
                hs = self._hs.pop(wgid, None)
                gen = hs[0] if hs else 0
                self.sessions[wgid] = _Sess(gen, token)
            elif mt == mux.G_REJECT:
                rgid, rcode, detail = mux.unpack_reject(payload)
                self.rejects.append((rgid, rcode, detail))
                self._hs.pop(rgid, None)
                self.sessions.pop(rgid, None)
                # terminal for the session: its in-flight bursts will
                # never get results — fail them now, loudly accounted
                for key in [k for k in self.outstanding if k[0] == rgid]:
                    del self.outstanding[key]
                    self.failed[key] = rcode
            elif mt == mux.G_PONG:
                self.pongs += 1
            elif mt == mux.G_STATS_REPLY:
                import json
                self.stats_replies.append(
                    json.loads(bytes(mux.gbody(payload)).decode()))
            elif mt == mux.G_ERROR:
                raise GatewayClientError(
                    bytes(mux.gbody(payload)).decode(errors="replace"))
            # anything else: ignore (forward-compatible)
        return done

    def _drain_in(self) -> int:
        """Non-blocking inbound drain."""
        done = 0
        while True:
            try:
                data = self.sock.recv(1 << 20)
            except (BlockingIOError, InterruptedError, ssl.SSLWantReadError):
                break
            if not data:
                raise GatewayClientError(
                    f"frontend closed the connection with "
                    f"{len(self.outstanding)} bursts outstanding")
            self._buf.feed(data)
            done += self._consume()
            if len(data) < (1 << 20) and not (
                    isinstance(self.sock, ssl.SSLSocket)
                    and self.sock.pending()):
                break
        return done

    def _flush_out(self, deadline: Optional[float] = None) -> None:
        if deadline is None:
            deadline = time.perf_counter() + self.timeout_s
        while self._out_off < len(self._out):
            try:
                k = self.sock.send(
                    memoryview(self._out)[self._out_off:])
                self._out_off += k
            except (BlockingIOError, InterruptedError,
                    ssl.SSLWantWriteError):
                if time.perf_counter() > deadline:
                    raise GatewayClientError("send timed out")
                self._drain_in()  # may QUEUE more (challenge answers)
                _wait_io(self.sock, 0.2, write=True)
        if self._out_off:
            self._out.clear()
            self._out_off = 0

    def _send(self, frame: bytes) -> None:
        self._out += frame
        self._flush_out()

    # ----------------------------- handshake ------------------------------ #

    def authenticate_many(self, gateway_ids, generations=None,
                          timeout_s: Optional[float] = None,
                          window: int = 1024) -> int:
        """Establish sessions for `gateway_ids` (pipelined per window);
        returns how many succeeded. Failures land in `rejects`."""
        gids = list(int(g) for g in np.atleast_1d(gateway_ids))
        gens = ([0] * len(gids) if generations is None
                else [int(g) for g in np.atleast_1d(generations)])
        deadline = time.perf_counter() + (
            timeout_s if timeout_s is not None else self.timeout_s)
        before = len(self.sessions)
        for lo in range(0, len(gids), window):
            chunk = gids[lo:lo + window]
            for gid, gen in zip(chunk, gens[lo:lo + window]):
                cnonce = auth.new_nonce()
                self._hs[gid] = (gen, cnonce)
                self._out += mux.pack_hello(gid, gen, cnonce)
            self._flush_out(deadline)
            # resolved = welcomed or rejected; wait the window out
            want = set(chunk)
            while any(g in self._hs for g in want):
                if time.perf_counter() > deadline:
                    raise GatewayClientError(
                        f"handshake timed out with "
                        f"{sum(g in self._hs for g in want)} unresolved")
                _wait_io(self.sock, 0.2)
                self._drain_in()
                self._flush_out(deadline)  # challenge answers queued
        return len(self.sessions) - before

    def authenticate(self, gateway_id: int, generation: int = 0,
                     timeout_s: Optional[float] = None) -> bool:
        self.authenticate_many([gateway_id], [generation],
                               timeout_s=timeout_s)
        return gateway_id in self.sessions

    # ------------------------------ traffic ------------------------------- #

    def submit(self, gateway_id: int, rows: np.ndarray,
               tier: int = 0) -> int:
        """Send one burst on an established session; returns its seq
        (open-loop: does not wait for the verdicts)."""
        s = self.sessions.get(gateway_id)
        if s is None:
            raise GatewayClientError(
                f"no established session for gateway {gateway_id}")
        seq = s.next_seq
        s.next_seq += 1
        n = len(rows) if np.ndim(rows) > 1 else 1
        self.outstanding[(gateway_id, seq)] = (n, time.perf_counter())
        self.rows_submitted += n
        self._send(mux.pack_submit(gateway_id, seq, s.token, rows,
                                   tier=tier))
        return seq

    def poll(self) -> int:
        return self._drain_in()

    def wait_all(self, timeout_s: Optional[float] = None) -> None:
        """Block until every outstanding burst resolved (result or
        session-level reject)."""
        deadline = time.perf_counter() + (
            timeout_s if timeout_s is not None else self.timeout_s)
        while self.outstanding:
            if time.perf_counter() > deadline:
                raise GatewayClientError(
                    f"timed out with {len(self.outstanding)} bursts "
                    "outstanding")
            _wait_io(self.sock, 0.2)
            self._drain_in()

    def ping(self, gateway_id: int = 0) -> None:
        self._send(mux.pack_simple(mux.G_PING, gateway_id))

    def bye(self, gateway_id: int) -> None:
        self.sessions.pop(gateway_id, None)
        self._send(mux.pack_simple(mux.G_BYE, gateway_id))

    def frontend_stats(self, timeout_s: Optional[float] = None) -> dict:
        before = len(self.stats_replies)
        self._send(mux.pack_simple(mux.G_STATS))
        deadline = time.perf_counter() + (
            timeout_s if timeout_s is not None else self.timeout_s)
        while len(self.stats_replies) == before:
            if time.perf_counter() > deadline:
                raise GatewayClientError("timed out waiting for stats")
            _wait_io(self.sock, 0.2)
            self._drain_in()
        return self.stats_replies[-1]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # ---------------------------- accounting ------------------------------ #

    def latencies_s(self) -> np.ndarray:
        return np.asarray([lat for _, _, lat in self.results.values()])

    def status_counts(self) -> Dict[str, int]:
        counts = np.zeros(4, np.int64)
        for statuses, _, _ in self.results.values():
            counts += np.bincount(statuses, minlength=4)[:4]
        return {wire.STATUS_NAMES[i]: int(counts[i]) for i in range(4)}
