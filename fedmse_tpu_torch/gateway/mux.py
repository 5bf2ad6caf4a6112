"""Multiplexed gateway-facing wire format (the ingest plane's frames).

The net plane's wire (net/wire.py) is a trusted-backend protocol: one
connection per peer, per-row gateway ids chosen by the SENDER, no
identity anywhere. The gateway plane inverts that trust: a frame's
gateway identity is the SESSION's, established once by an authenticated
handshake (auth.py), and every subsequent frame is checked against the
session table BEFORE its row bytes are touched. Many sessions share one
TCP connection (a gateway concentrator, or simply a frontend holding
~1M mostly-idle gateways on a few thousand sockets), so every frame
carries the session key — the absolute gateway id — in its fixed
header.

Framing is the SAME length-prefix discipline as net/wire.py (u32
big-endian payload length, MAX_FRAME guard, FrameBuffer splitting), so
one socket-reading loop serves both planes. The payload header is

    u8  msg_type      (G_* below)
    u8  code          (G_REJECT reason / flags; 0 elsewhere)
    u32 gateway_id    (the session key — absolute slot id)
    u64 seq           (per-session sequence; echoed in G_RESULT)

and continues per type:

  G_HELLO      u64 generation, 16B client nonce. The roster check
               happens HERE: an unknown/retired/mismatched-generation
               slot is terminated with G_REJECT(UNKNOWN_GATEWAY) before
               the plane ever sees a row byte from it.
  G_CHALLENGE  16B server nonce.
  G_AUTH       32B HMAC-SHA256 transcript tag (auth.py session_mac).
  G_WELCOME    16B session token — the per-session bearer the frontend
               checks on every G_SUBMIT (constant-time), so a hijacked
               connection cannot submit as someone else's session.
  G_REJECT     u8-coded reason (REJ_* below) + UTF-8 detail. Terminal
               for the SESSION; the connection lives, but a peer with
               no established session accumulates strikes per reject
               and is disconnected past the frontend's budget.
  G_SUBMIT     16B token, u32 n_rows, u32 dim, u8 tier, f64 t_sent,
               then n_rows*dim f32 row bytes. The token sits BEFORE the
               row block so verification never parses rows it will
               reject. No per-row gateway ids: the session IS the
               gateway (the frontend stamps the id server-side).
  G_RESULT     u32 n_rows, n u8 statuses (net/wire.STATUS_*), n f32
               scores — same per-row terminal-status contract as the
               net plane, correlated by (gateway_id, seq).
  G_PING/G_PONG  empty keepalives for parked sessions.
  G_BYE        empty; closes the session (not the connection).
  G_ERROR      UTF-8 message; connection-fatal.

Integers big-endian (`!`), bulk arrays little-endian (`<f4`) — the
net/wire.py convention, memcpy on every deployment target.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from fedmse_tpu_torch.net.wire import MAX_FRAME, WireError, _LEN

# message-type space disjoint from net/wire.MSG_* (1..8) so a frame
# accidentally crossing planes fails loudly as "unknown msg_type"
G_HELLO = 32
G_CHALLENGE = 33
G_AUTH = 34
G_WELCOME = 35
G_REJECT = 36
G_SUBMIT = 37
G_RESULT = 38
G_PING = 39
G_PONG = 40
G_BYE = 41
G_ERROR = 42
# operator frames (UTF-8 JSON reply body). The ingest wire is
# internet-facing; deployments gate G_STATS at the network layer (ops
# VLAN / loopback) — the frontend answers it to whoever can reach it,
# which for the bench topology is the parent process
G_STATS = 43
G_STATS_REPLY = 44

# G_REJECT reason codes
REJ_UNKNOWN_GATEWAY = 1   # not in the roster / retired / generation mismatch
REJ_BAD_MAC = 2           # handshake transcript tag failed verification
REJ_BAD_TOKEN = 3         # G_SUBMIT token != the session's bearer
REJ_BAD_STATE = 4         # frame out of handshake order / no such session
REJ_OVER_SESSION_CAP = 5  # connection exceeded its session budget

REJ_NAMES = {REJ_UNKNOWN_GATEWAY: "unknown_gateway",
             REJ_BAD_MAC: "bad_mac", REJ_BAD_TOKEN: "bad_token",
             REJ_BAD_STATE: "bad_state",
             REJ_OVER_SESSION_CAP: "over_session_cap"}

NONCE_LEN = 16
MAC_LEN = 32
TOKEN_LEN = 16

_GHEAD = struct.Struct("!BBIQ")     # msg_type, code, gateway_id, seq
_GHELLO = struct.Struct("!Q")       # generation
_GSUBMIT = struct.Struct("!IIBd")   # n_rows, dim, tier, t_sent
_GRESULT = struct.Struct("!I")      # n_rows

HEADER_LEN = _GHEAD.size

# byte offset of t_sent within a whole G_SUBMIT frame (length prefix
# included) — pre-packed load generators patch it like net/wire's
T_SENT_OFFSET = _LEN.size + _GHEAD.size + TOKEN_LEN + 4 + 4 + 1
SEQ_OFFSET = _LEN.size + 6


def _frame(head: bytes, *parts: bytes) -> bytes:
    n = len(head) + sum(len(p) for p in parts)
    if n > MAX_FRAME:
        raise WireError(f"frame of {n} bytes exceeds MAX_FRAME {MAX_FRAME}")
    return b"".join((_LEN.pack(n), head) + parts)


def parse_gheader(payload: memoryview) -> Tuple[int, int, int, int]:
    """(msg_type, code, gateway_id, seq) of any gateway-plane payload."""
    if len(payload) < _GHEAD.size:
        raise WireError(f"gateway frame of {len(payload)} bytes is shorter "
                        f"than the {_GHEAD.size}-byte header")
    return _GHEAD.unpack_from(payload, 0)


def gbody(payload: memoryview) -> memoryview:
    return payload[_GHEAD.size:]


# ----------------------------- handshake ------------------------------- #

def pack_hello(gateway_id: int, generation: int,
               client_nonce: bytes) -> bytes:
    if len(client_nonce) != NONCE_LEN:
        raise WireError(f"client nonce must be {NONCE_LEN} bytes")
    return _frame(_GHEAD.pack(G_HELLO, 0, gateway_id, 0),
                  _GHELLO.pack(generation), client_nonce)


def unpack_hello(payload: memoryview) -> Tuple[int, int, bytes]:
    """-> (gateway_id, generation, client_nonce)."""
    _, _, gid, _ = _GHEAD.unpack_from(payload, 0)
    off = _GHEAD.size
    if len(payload) != off + _GHELLO.size + NONCE_LEN:
        raise WireError("malformed G_HELLO")
    (generation,) = _GHELLO.unpack_from(payload, off)
    return gid, generation, bytes(payload[off + _GHELLO.size:])


def pack_challenge(gateway_id: int, server_nonce: bytes) -> bytes:
    if len(server_nonce) != NONCE_LEN:
        raise WireError(f"server nonce must be {NONCE_LEN} bytes")
    return _frame(_GHEAD.pack(G_CHALLENGE, 0, gateway_id, 0), server_nonce)


def unpack_challenge(payload: memoryview) -> Tuple[int, bytes]:
    if len(payload) != _GHEAD.size + NONCE_LEN:
        raise WireError("malformed G_CHALLENGE")
    _, _, gid, _ = _GHEAD.unpack_from(payload, 0)
    return gid, bytes(payload[_GHEAD.size:])


def pack_auth(gateway_id: int, mac: bytes) -> bytes:
    if len(mac) != MAC_LEN:
        raise WireError(f"auth MAC must be {MAC_LEN} bytes")
    return _frame(_GHEAD.pack(G_AUTH, 0, gateway_id, 0), mac)


def unpack_auth(payload: memoryview) -> Tuple[int, bytes]:
    if len(payload) != _GHEAD.size + MAC_LEN:
        raise WireError("malformed G_AUTH")
    _, _, gid, _ = _GHEAD.unpack_from(payload, 0)
    return gid, bytes(payload[_GHEAD.size:])


def pack_welcome(gateway_id: int, token: bytes) -> bytes:
    if len(token) != TOKEN_LEN:
        raise WireError(f"session token must be {TOKEN_LEN} bytes")
    return _frame(_GHEAD.pack(G_WELCOME, 0, gateway_id, 0), token)


def unpack_welcome(payload: memoryview) -> Tuple[int, bytes]:
    if len(payload) != _GHEAD.size + TOKEN_LEN:
        raise WireError("malformed G_WELCOME")
    _, _, gid, _ = _GHEAD.unpack_from(payload, 0)
    return gid, bytes(payload[_GHEAD.size:])


def pack_reject(gateway_id: int, code: int, detail: str = "") -> bytes:
    return _frame(_GHEAD.pack(G_REJECT, code, gateway_id, 0),
                  detail.encode())


def unpack_reject(payload: memoryview) -> Tuple[int, int, str]:
    """-> (gateway_id, reason code, detail)."""
    _, code, gid, _ = _GHEAD.unpack_from(payload, 0)
    return gid, code, bytes(payload[_GHEAD.size:]).decode(errors="replace")


# ------------------------------- traffic ------------------------------- #

def pack_submit(gateway_id: int, seq: int, token: bytes, rows: np.ndarray,
                tier: int = 0, t_sent: Optional[float] = None) -> bytes:
    """One session burst -> one G_SUBMIT frame (rows f32 [n, D]; every
    row belongs to the session's gateway)."""
    import time as _time

    if len(token) != TOKEN_LEN:
        raise WireError(f"session token must be {TOKEN_LEN} bytes")
    rows = np.ascontiguousarray(rows).astype("<f4", copy=False)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, dim = rows.shape
    if t_sent is None:
        t_sent = _time.time()
    return _frame(_GHEAD.pack(G_SUBMIT, 0, gateway_id, seq), token,
                  _GSUBMIT.pack(n, dim, tier, t_sent), rows.tobytes())


def submit_token(payload: memoryview) -> bytes:
    """The token of a G_SUBMIT payload WITHOUT parsing anything past it
    — the pre-row-parse verification read (frontend.py checks this and
    the session table before unpack_submit_rows ever runs)."""
    if len(payload) < _GHEAD.size + TOKEN_LEN + _GSUBMIT.size:
        raise WireError("malformed G_SUBMIT (short of its fixed header)")
    return bytes(payload[_GHEAD.size:_GHEAD.size + TOKEN_LEN])


def unpack_submit_rows(payload: memoryview, copy: bool = False
                       ) -> Tuple[int, np.ndarray, int, float]:
    """G_SUBMIT payload -> (seq, rows [n, D] f32, tier, t_sent). Only
    called AFTER submit_token/session verification passed. copy=False
    returns zero-copy views (fresh per-frame buffers, like the net
    server's readexactly path)."""
    _, _, _, seq = _GHEAD.unpack_from(payload, 0)
    off = _GHEAD.size + TOKEN_LEN
    n, dim, tier, t_sent = _GSUBMIT.unpack_from(payload, off)
    off += _GSUBMIT.size
    if len(payload) != off + n * dim * 4:
        raise WireError(f"G_SUBMIT of {len(payload)} bytes does not match "
                        f"its declared [{n} x {dim}] shape")
    rows = np.frombuffer(payload, "<f4", n * dim, off).reshape(n, dim)
    if copy or rows.dtype != np.float32:
        rows = rows.astype(np.float32)
    return seq, rows, tier, t_sent


def pack_result(gateway_id: int, seq: int, statuses: np.ndarray,
                scores: np.ndarray) -> bytes:
    st = np.ascontiguousarray(statuses, np.uint8)
    sc = np.ascontiguousarray(scores).astype("<f4", copy=False)
    if st.shape != sc.shape:
        raise WireError(f"statuses {st.shape} and scores {sc.shape} must "
                        f"cover the same rows")
    return _frame(_GHEAD.pack(G_RESULT, 0, gateway_id, seq),
                  _GRESULT.pack(len(st)), st.tobytes(), sc.tobytes())


def unpack_result(payload: memoryview
                  ) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """-> (gateway_id, seq, statuses, scores)."""
    _, _, gid, seq = _GHEAD.unpack_from(payload, 0)
    off = _GHEAD.size
    (n,) = _GRESULT.unpack_from(payload, off)
    off += _GRESULT.size
    if len(payload) != off + n * 5:
        raise WireError(f"G_RESULT of {len(payload)} bytes does not match "
                        f"its declared {n} rows")
    statuses = np.frombuffer(payload, np.uint8, n, off).copy()
    scores = np.frombuffer(payload, "<f4", n,
                           off + n).astype(np.float32)
    return gid, seq, statuses, scores


def pack_simple(msg_type: int, gateway_id: int = 0, seq: int = 0,
                body: bytes = b"") -> bytes:
    """G_PING / G_PONG / G_BYE / G_ERROR frames."""
    return _frame(_GHEAD.pack(msg_type, 0, gateway_id, seq), body)
