"""Blocking client for the network serving plane + RemoteReplica (port of
fedmse_tpu/net/client.py).

`NetClient` is deliberately an OPEN-LOOP client: `submit()` frames a
burst and returns its request id without waiting — the caller decides
when (and whether) to look at results via `poll()` (non-blocking drain
of whatever RESULT frames the kernel already buffered) or
`wait_all()`. That is the load generator's contract (an open-loop
arrival process must never be back-pressured by its own
completions, or the measured system sets the offered rate) and also the
right shape for a gateway concentrator that fires NIC batches and reads
verdicts opportunistically.

`RemoteReplica` adapts one NetClient to the router's replica interface
(router.LocalReplica's submit_many / poll / drain / swap / stats), so a
front-tier `Router` can stripe admitted bursts over replica SERVER
PROCESSES exactly as it stripes over in-process engines — the
multi-process topology: N worker processes each running
`python -m fedmse_tpu_torch.net.server --no-admission`, one front
process owning roster + admission + autoscaling. A swap crosses the wire
as numpy only (`host_payload`): the front's tensors, banks and centroid
statistics are copied to host arrays before they are pickled, and the
worker places them on its own device, so no pickled CUDA tensor ever
reaches a socket. The worker returns exactly
one terminal status per row (the wire contract), and those statuses
pass through the front's RouteResult VERBATIM — a worker misdeployed
with its own admission still surfaces its SHED verdicts to the end
client as SHED, never relabeled.
"""

from __future__ import annotations

import dataclasses
import json
import select
import socket
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fedmse_tpu_torch.net import wire


def host_payload(payload: Dict) -> Dict:
    """A swap payload with every tensor replaced by a host numpy array
    (kernels in a reduced dtype widened to f32, which is exact); the
    containers (dicts, ReferenceBank, CentroidClassifier, the numpy-only
    calibration and roster) keep their types."""
    import torch

    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.is_floating_point() and v.dtype != torch.float32:
                v = v.float()
            return v.numpy()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            fields = {f.name: getattr(v, f.name)
                      for f in dataclasses.fields(v)}
            moved = {k: host(x) for k, x in fields.items()}
            if any(moved[k] is not fields[k] for k in fields):
                return dataclasses.replace(v, **moved)
        return v

    return {k: host(v) for k, v in payload.items()}


class NetClientError(RuntimeError):
    """Protocol violation / timeout / peer-reported MSG_ERROR."""


class NetClient:
    """One TCP connection to a NetFront (module docstring)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # non-blocking: _send() interleaves reads whenever the kernel
        # send buffer is full. A blocking sendall would deadlock against
        # a server whose responses we are not reading — the server's
        # write buffer fills, it stops reading, our sendall never
        # completes, nobody drains anybody.
        self.sock.setblocking(False)
        self.timeout_s = timeout_s
        self._buf = wire.FrameBuffer()
        self._next_id = 1
        # request_id -> (n_rows, t_submit); completed -> result tuple
        self.outstanding: Dict[int, Tuple[int, float]] = {}
        self.results: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        self.rows_submitted = 0
        self._control: List = []  # buffered SWAP_ACK / STATS_REPLY frames

    # ----------------------------- submit -------------------------------- #

    def _send(self, data: bytes) -> None:
        """Write a whole frame, draining inbound frames whenever the
        send buffer is full (the anti-deadlock half of the open loop)."""
        view = memoryview(data)
        deadline = time.perf_counter() + self.timeout_s
        while view:
            try:
                view = view[self.sock.send(view):]
            except (BlockingIOError, InterruptedError):
                if time.perf_counter() > deadline:
                    raise NetClientError("send timed out")
                r, w, _ = select.select([self.sock], [self.sock], [], 0.5)
                if r:
                    data_in = self.sock.recv(1 << 20)
                    if not data_in:
                        raise NetClientError("server closed mid-send")
                    self._buf.feed(data_in)
                    self._consume()

    def submit(self, rows: np.ndarray, gateway_ids,
               tiers=None) -> int:
        """Send one burst; returns its request id (open-loop: does not
        wait for the verdicts)."""
        rid = self._next_id
        self._next_id += 1
        frame = wire.pack_submit(rid, rows, gateway_ids, tiers)
        n = len(rows) if np.ndim(rows) > 1 else 1
        self.outstanding[rid] = (n, time.perf_counter())
        self.rows_submitted += n
        self._send(frame)
        return rid

    # ----------------------------- results -------------------------------- #

    def poll(self) -> int:
        """Drain whatever whole frames the kernel buffered (never
        blocks); returns how many requests completed on this call."""
        done = 0
        while True:
            r, _, _ = select.select([self.sock], [], [], 0)
            if not r:
                break
            data = self.sock.recv(1 << 20)
            if not data:
                raise NetClientError("server closed the connection with "
                                     f"{len(self.outstanding)} requests "
                                     "outstanding")
            self._buf.feed(data)
            done += self._consume()
        return done

    def _consume(self) -> int:
        done = 0
        for payload in self._buf.frames():
            t, rid = wire.parse_header(payload)
            if t == wire.MSG_RESULT:
                rid, statuses, scores = wire.unpack_result(payload)
                meta = self.outstanding.pop(rid, None)
                if meta is None:
                    raise NetClientError(
                        f"duplicate or unknown RESULT for request {rid}")
                n, t0 = meta
                if len(statuses) != n:
                    raise NetClientError(
                        f"request {rid}: submitted {n} rows, result "
                        f"carries {len(statuses)}")
                self.results[rid] = (statuses, scores,
                                     time.perf_counter() - t0)
                done += 1
            elif t == wire.MSG_ERROR:
                raise NetClientError(
                    bytes(wire.body(payload)).decode(errors="replace"))
            else:
                self._control.append(payload)
        return done

    def wait_all(self, timeout_s: Optional[float] = None) -> None:
        """Block until every outstanding request resolved."""
        deadline = time.perf_counter() + (timeout_s if timeout_s is not None
                                          else self.timeout_s)
        while self.outstanding:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise NetClientError(
                    f"timed out with {len(self.outstanding)} requests "
                    "outstanding")
            r, _, _ = select.select([self.sock], [], [], min(left, 0.5))
            if r:
                data = self.sock.recv(1 << 20)
                if not data:
                    raise NetClientError("server closed mid-wait")
                self._buf.feed(data)
                self._consume()

    # ----------------------------- control -------------------------------- #

    def _wait_control(self, want_type: int, rid: int,
                      timeout_s: Optional[float]) -> memoryview:
        deadline = time.perf_counter() + (timeout_s if timeout_s is not None
                                          else self.timeout_s)
        while True:
            for i, payload in enumerate(self._control):
                t, got = wire.parse_header(payload)
                if t == want_type and got == rid:
                    return self._control.pop(i)
            left = deadline - time.perf_counter()
            if left <= 0:
                raise NetClientError(
                    f"timed out waiting for control reply {want_type}")
            r, _, _ = select.select([self.sock], [], [], min(left, 0.5))
            if r:
                data = self.sock.recv(1 << 20)
                if not data:
                    raise NetClientError("server closed mid-control")
                self._buf.feed(data)
                self._consume()

    def swap(self, payload: Dict, timeout_s: Optional[float] = None) -> Dict:
        """Send one atomic swap payload (params/banks/centroids/
        calibration/roster keywords of Router.swap), as host arrays
        (`host_payload`); returns the event."""
        rid = self._next_id
        self._next_id += 1
        self._send(wire.pack_swap(rid, host_payload(payload)))
        ack = self._wait_control(wire.MSG_SWAP_ACK, rid, timeout_s)
        return json.loads(bytes(wire.body(ack)).decode())

    def stats(self, timeout_s: Optional[float] = None) -> Dict:
        rid = self._next_id
        self._next_id += 1
        self._send(wire.pack_control(wire.MSG_STATS, rid))
        reply = self._wait_control(wire.MSG_STATS_REPLY, rid, timeout_s)
        return json.loads(bytes(wire.body(reply)).decode())

    def close(self) -> None:
        try:
            self._send(wire.pack_control(wire.MSG_CLOSE))
        except (OSError, NetClientError):
            pass
        self.sock.close()

    # ---------------------------- accounting ------------------------------ #

    def latencies_s(self) -> np.ndarray:
        """Per-request completion latencies (submit -> result parsed)."""
        return np.asarray([lat for _, _, lat in self.results.values()])

    def status_counts(self) -> Dict[str, int]:
        counts = np.zeros(4, np.int64)
        for statuses, _, _ in self.results.values():
            counts += np.bincount(statuses, minlength=4)[:4]
        return {wire.STATUS_NAMES[i]: int(counts[i]) for i in range(4)}


class _RemoteBlock:
    """TicketBlock-alike for one remote burst: completes when its
    RESULT frame lands; exposes the done/scores/verdicts surface
    RouteResult.finalize reads. The result is POPPED out of the client's
    table on first touch (the front holds RouteResults, not the client —
    a long-lived remote replica must not accumulate every response)."""

    __slots__ = ("client", "rid", "n", "_statuses", "_scores")

    def __init__(self, client: NetClient, rid: int, n: int):
        self.client = client
        self.rid = rid
        self.n = n
        self._statuses = None
        self._scores = None

    def __len__(self) -> int:
        return self.n

    def _fetch(self) -> bool:
        if self._scores is not None:
            return True
        res = self.client.results.pop(self.rid, None)
        if res is None:
            return False
        self._statuses, self._scores = res[0], res[1]
        return True

    @property
    def done(self) -> bool:
        return self._fetch()

    @property
    def scores(self):
        return self._scores if self._fetch() else None

    @property
    def verdicts(self):
        if not self._fetch():
            return None
        return self._statuses == wire.STATUS_ANOMALY

    @property
    def raw_statuses(self):
        """The worker's own terminal statuses — RouteResult.finalize
        passes them through verbatim, so a worker-side SHED or
        UNKNOWN_GATEWAY is never relabeled as a normal verdict."""
        return self._statuses if self._fetch() else None


class RemoteReplica:
    """A replica SERVER PROCESS as a router stripe target (module
    docstring). `num_gateways`/`max_batch` mirror the worker's build
    (the front and its workers deploy from one config)."""

    def __init__(self, host: str, port: int, num_gateways: int,
                 max_batch: int = 1024, name: Optional[str] = None,
                 timeout_s: float = 30.0):
        self.client = NetClient(host, port, timeout_s=timeout_s)
        self.num_gateways = num_gateways
        self.max_batch = max_batch
        self.name = name or f"remote:{host}:{port}"
        self.engine = None  # no in-process engine; roster lives router-side
        self.swap_events: List[Dict] = []

    def submit_many(self, rows: np.ndarray, gws: np.ndarray) -> _RemoteBlock:
        rid = self.client.submit(rows, gws)
        return _RemoteBlock(self.client, rid, len(rows))

    def poll(self) -> bool:
        return self.client.poll() > 0

    def drain(self) -> None:
        self.client.wait_all()

    def swap(self, **payload) -> Dict:
        event = self.client.swap(
            {k: v for k, v in payload.items() if v is not None})
        self.swap_events.append(event)
        return event

    def stats(self) -> Dict:
        st = self.client.stats()
        st["name"] = self.name
        # surface the worker's own front percentiles at the router level
        router = st.get("router", {})
        per = router.get("per_replica", [])
        st["latency_p99_ms"] = max(
            (s["latency_p99_ms"] for s in per
             if s.get("latency_p99_ms") is not None), default=None)
        st["rows_per_sec_wall"] = router.get("rows_per_sec_wall_sum")
        st["rows_served"] = router.get("rows_served", 0)
        return st

    def close(self) -> None:
        self.client.close()
