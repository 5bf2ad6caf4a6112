"""Length-prefixed binary wire format for the network serving plane (port
of fedmse_tpu/net/wire.py: the same frames, byte for byte).

The serving front's intake contract (serving/continuous.py
`submit_many`) wants NIC-poll-shaped bursts: a contiguous block of rows
that arrived together, admitted as array slices, not per-row python
objects. The wire format is designed so a socket read deserializes
STRAIGHT into that shape — one `np.frombuffer` for the row block, one
for the gateway ids, one for the tiers — with zero per-row python work
on either side. Everything is stdlib (`struct` + numpy buffers); no
protobuf/gRPC dependency enters the repo.

Framing: every frame is `u32 payload_length` (big-endian) followed by
`payload_length` bytes of payload. The payload starts with a fixed
header

    u8  msg_type      (MSG_* below)
    u8  reserved
    u64 request_id    (client-chosen correlation id; echoed in RESULT)

and continues per type:

  SUBMIT   u32 n_rows, u32 dim, u8 tier_mode, f64 t_sent (sender wall
           clock, time.time() — the staleness signal admission's
           age-based shedding reads; same-host deployments compare
           clocks exactly, cross-host ones need NTP-grade sync or the
           age gate disabled), then n_rows*dim f32 row bytes, n_rows
           i32 gateway ids, and (tier_mode=1) n_rows u8 priority tiers
           (tier_mode=0: every row is tier 0 — the common single-tier
           client skips the array entirely).
  RESULT   u32 n_rows, then n_rows u8 per-row statuses (STATUS_* below)
           and n_rows f32 scores (NaN for rows that were never scored:
           SHED / UNKNOWN_GATEWAY). Row order is the SUBMIT order.
  SWAP     pickled payload dict (params/centroids/banks/calibration/
           roster keyword arguments of Router.swap). Pickle crosses a
           TRUST BOUNDARY: the serving plane is an internal backend
           protocol between co-deployed processes (the flywheel
           trainer, the bench, replica workers), not an internet-facing
           API — DESIGN.md §18 spells out the deployment assumption.
  SWAP_ACK / STATS_REPLY   UTF-8 JSON bytes (the swap event / the
           router's aggregated stats).
  STATS / CLOSE   empty payloads.
  ERROR    UTF-8 message bytes (the peer's loud failure path).

Struct integers are big-endian (`!` order); the bulk array blocks are
explicitly LITTLE-endian (`<f4`/`<i4` — numpy-native on every
deployment target, so the hot path is a straight memcpy). Frames above
MAX_FRAME bytes fail loudly on both sides — a corrupt length prefix
must not turn into a multi-GB allocation.
"""

from __future__ import annotations

import pickle
import struct
from typing import Optional, Tuple

import numpy as np

MSG_SUBMIT = 1
MSG_RESULT = 2
MSG_SWAP = 3
MSG_SWAP_ACK = 4
MSG_STATS = 5
MSG_STATS_REPLY = 6
MSG_CLOSE = 7
MSG_ERROR = 8

# Per-row terminal statuses. Every submitted row gets EXACTLY ONE of
# these back — shedding and roster rejection are explicit verdicts in
# the response stream, never silent drops (DESIGN.md §18).
STATUS_NORMAL = 0            # scored; verdict: not anomalous
STATUS_ANOMALY = 1           # scored; verdict: anomalous
STATUS_SHED = 2              # admission control shed the row unscored
STATUS_UNKNOWN_GATEWAY = 3   # routed to a retired roster slot

STATUS_NAMES = {STATUS_NORMAL: "normal", STATUS_ANOMALY: "anomaly",
                STATUS_SHED: "shed",
                STATUS_UNKNOWN_GATEWAY: "unknown_gateway"}

_LEN = struct.Struct("!I")
_HEAD = struct.Struct("!BBQ")          # msg_type, reserved, request_id
_SUBMIT = struct.Struct("!IIBd")       # n_rows, dim, tier_mode, t_sent
_RESULT = struct.Struct("!I")          # n_rows

# byte offset of t_sent within a whole SUBMIT frame (length prefix
# included) — load generators patch it in pre-packed frames
T_SENT_OFFSET = _LEN.size + _HEAD.size + 4 + 4 + 1
REQUEST_ID_OFFSET = _LEN.size + 2

MAX_FRAME = 64 * 1024 * 1024


class WireError(RuntimeError):
    """Malformed frame / oversized length prefix / protocol violation."""


def _frame(head: bytes, *parts: bytes) -> bytes:
    n = len(head) + sum(len(p) for p in parts)
    if n > MAX_FRAME:
        raise WireError(f"frame of {n} bytes exceeds MAX_FRAME {MAX_FRAME}")
    return b"".join((_LEN.pack(n), head) + parts)


def pack_submit(request_id: int, rows: np.ndarray, gateway_ids: np.ndarray,
                tiers: Optional[np.ndarray] = None,
                t_sent: Optional[float] = None) -> bytes:
    """One burst -> one SUBMIT frame (rows f32 [n, D], gateways i32 [n],
    tiers u8 [n] or None = all tier 0). `t_sent` defaults to the sender
    wall clock now."""
    import time as _time

    rows = np.ascontiguousarray(rows).astype("<f4", copy=False)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, dim = rows.shape
    gw = np.ascontiguousarray(
        np.broadcast_to(np.asarray(gateway_ids, np.int32),
                        (n,))).astype("<i4", copy=False)
    head = _HEAD.pack(MSG_SUBMIT, 0, request_id)
    if t_sent is None:
        t_sent = _time.time()
    if tiers is None:
        sub = _SUBMIT.pack(n, dim, 0, t_sent)
        return _frame(head, sub, rows.tobytes(), gw.tobytes())
    tr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(tiers, np.uint8), (n,)))
    sub = _SUBMIT.pack(n, dim, 1, t_sent)
    return _frame(head, sub, rows.tobytes(), gw.tobytes(), tr.tobytes())


def unpack_submit(payload: memoryview, copy: bool = True
                  ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray,
                             float]:
    """SUBMIT payload (header included) -> (request_id, rows [n, D] f32,
    gateways [n] i32, tiers [n] u8, t_sent). With `copy=True` (default)
    the arrays are detached copies. `copy=False` returns zero-copy
    VIEWS over the payload buffer — safe exactly when the buffer is a
    fresh per-frame allocation nobody reuses (the asyncio server's
    readexactly bytes): the serving front's intake copies whatever
    reaches a forming window anyway, so the view path makes that the
    burst's ONLY row copy. On a big-endian host the view dtypes are
    non-native and copy=False falls back to converting copies."""
    _, _, request_id = _HEAD.unpack_from(payload, 0)
    off = _HEAD.size
    n, dim, tier_mode, t_sent = _SUBMIT.unpack_from(payload, off)
    off += _SUBMIT.size
    row_bytes = n * dim * 4
    want = off + row_bytes + n * 4 + (n if tier_mode else 0)
    if len(payload) != want:
        raise WireError(f"SUBMIT frame of {len(payload)} bytes does not "
                        f"match its declared [{n} x {dim}] shape ({want})")
    rows = np.frombuffer(payload, "<f4", n * dim, off).reshape(n, dim)
    off += row_bytes
    gw = np.frombuffer(payload, "<i4", n, off)
    if copy or rows.dtype != np.float32 or gw.dtype != np.int32:
        rows = rows.astype(np.float32)
        gw = gw.astype(np.int32)
    off += n * 4
    if tier_mode:
        tiers = np.frombuffer(payload, np.uint8, n, off).copy()
    else:
        tiers = np.zeros(n, np.uint8)
    return request_id, rows, gw, tiers, t_sent


def pack_result(request_id: int, statuses: np.ndarray,
                scores: np.ndarray) -> bytes:
    """Per-row terminal statuses + scores -> one RESULT frame."""
    st = np.ascontiguousarray(statuses, np.uint8)
    sc = np.ascontiguousarray(scores).astype("<f4", copy=False)
    if st.shape != sc.shape:
        raise WireError(f"statuses {st.shape} and scores {sc.shape} must "
                        f"cover the same rows")
    head = _HEAD.pack(MSG_RESULT, 0, request_id)
    return _frame(head, _RESULT.pack(len(st)), st.tobytes(), sc.tobytes())


def unpack_result(payload: memoryview
                  ) -> Tuple[int, np.ndarray, np.ndarray]:
    _, _, request_id = _HEAD.unpack_from(payload, 0)
    off = _HEAD.size
    (n,) = _RESULT.unpack_from(payload, off)
    off += _RESULT.size
    if len(payload) != off + n * 5:
        raise WireError(f"RESULT frame of {len(payload)} bytes does not "
                        f"match its declared {n} rows")
    statuses = np.frombuffer(payload, np.uint8, n, off).copy()
    scores = np.frombuffer(payload, "<f4", n,
                           off + n).astype(np.float32)
    return request_id, statuses, scores


def pack_control(msg_type: int, request_id: int = 0,
                 body: bytes = b"") -> bytes:
    """SWAP / SWAP_ACK / STATS / STATS_REPLY / CLOSE / ERROR frames."""
    return _frame(_HEAD.pack(msg_type, 0, request_id), body)


def pack_swap(request_id: int, payload: dict) -> bytes:
    return pack_control(MSG_SWAP, request_id, pickle.dumps(payload, 4))


def unpack_swap(payload: memoryview) -> Tuple[int, dict]:
    _, _, request_id = _HEAD.unpack_from(payload, 0)
    return request_id, pickle.loads(bytes(payload[_HEAD.size:]))


def parse_header(payload: memoryview) -> Tuple[int, int]:
    """(msg_type, request_id) of any payload."""
    t, _, request_id = _HEAD.unpack_from(payload, 0)
    return t, request_id


def body(payload: memoryview) -> memoryview:
    """The type-specific bytes after the fixed header."""
    return payload[_HEAD.size:]


# ------------------------- blocking-socket side ------------------------- #
# The asyncio server reads frames with StreamReader.readexactly; the
# blocking side (NetClient, RemoteReplica, the bench's load generators)
# shares these helpers. recv_frames() is the NON-blocking drain used by
# poll paths: it consumes whatever whole frames the kernel already
# buffered and never waits.

def recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise WireError("peer closed mid-frame")
        got += k
    return bytes(buf)


def read_frame_blocking(sock) -> memoryview:
    (n,) = _LEN.unpack(recv_exact(sock, 4))
    if n > MAX_FRAME:
        raise WireError(f"frame length {n} exceeds MAX_FRAME {MAX_FRAME}")
    return memoryview(recv_exact(sock, n))


class FrameBuffer:
    """Incremental frame splitter for a non-blocking socket: feed() raw
    bytes as they arrive, iterate complete payloads.

    Consumption is an OFFSET, not a del-from-front: deleting a frame's
    bytes off the head of the bytearray memmoves the whole remainder,
    which turns a backlog of K small frames (the gateway plane's
    handshake storms: thousands of ~50-byte frames buffered behind one
    feed) into O(K * backlog) copying. The offset advances per frame
    and the buffer compacts once — when fully consumed (free) or when
    the dead prefix outgrows _COMPACT_AT (one amortized memmove)."""

    _COMPACT_AT = 64 * 1024

    def __init__(self):
        self._buf = bytearray()
        self._off = 0   # bytes already consumed off the front

    def __len__(self) -> int:
        return len(self._buf) - self._off

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def frames(self):
        while True:
            avail = len(self._buf) - self._off
            if avail < 4:
                break
            (n,) = _LEN.unpack_from(self._buf, self._off)
            if n > MAX_FRAME:
                raise WireError(f"frame length {n} exceeds MAX_FRAME "
                                f"{MAX_FRAME}")
            if avail < 4 + n:
                break
            start = self._off + 4
            payload = bytes(self._buf[start:start + n])
            self._off = start + n
            yield memoryview(payload)
        if self._off and (self._off >= len(self._buf)
                          or self._off > self._COMPACT_AT):
            del self._buf[:self._off]
            self._off = 0
