"""The frontend's session table: ~1M gateways on a few thousand sockets.

One entry per AUTHENTICATED gateway, keyed by absolute gateway id (the
same key the tiered store and the roster use). The design constraint is
the million-gateway shape from DESIGN.md §20: almost every session is
idle almost always, so nothing here may cost per-session work on the
hot loop — a parked session is one dict entry and its connection's
epoll registration, touched again only when a frame carrying its id
arrives. The ACTIVE set (sessions with traffic inside `park_after_s`)
is the only thing the drive loop ever iterates, and parking scans that
small set, never the table.

Admission isolation (the shed-storm defense, net/admission.py
SessionIsolation) hangs off the table: each session's submit passes
through a per-session rate cap BEFORE the shared capacity bucket, so a
flooding coalition exhausts its own caps — not the bucket the honest
fleet's admissions drain from. The cap only engages above
`session_share` of fleet capacity, which no honest gateway approaches:
clean cost is structurally zero (measured in redteam_sweep's
shed-storm cell).
"""

from __future__ import annotations

import hmac
import time
from typing import Dict, Optional, Set

from fedmse_tpu_torch.gateway import auth


class Session:
    """One authenticated gateway's state (slots — the table is the
    plane's biggest host structure; at 1M sessions every field counts)."""

    __slots__ = ("gateway_id", "generation", "token", "conn_id",
                 "established_at", "last_seen", "seq_seen",
                 "rows_offered", "rows_admitted", "rows_shed",
                 "pending")

    def __init__(self, gateway_id: int, generation: int, token: bytes,
                 conn_id: int, now: float):
        self.gateway_id = gateway_id
        self.generation = generation
        self.token = token
        self.conn_id = conn_id
        self.established_at = now
        self.last_seen = now
        self.seq_seen = 0          # highest G_SUBMIT seq observed
        self.rows_offered = 0
        self.rows_admitted = 0
        self.rows_shed = 0
        self.pending = 0           # in-flight bursts (results not yet sent)

    def check_token(self, token: bytes) -> bool:
        return hmac.compare_digest(self.token, token)


class PendingHandshake:
    """HELLO->AUTH window state: the server nonce we issued and what it
    was issued FOR. Bounded per connection (frontend.py) so a peer
    cannot grow state by spraying HELLOs it never completes."""

    __slots__ = ("gateway_id", "generation", "client_nonce",
                 "server_nonce", "issued_at")

    def __init__(self, gateway_id: int, generation: int,
                 client_nonce: bytes, server_nonce: bytes, now: float):
        self.gateway_id = gateway_id
        self.generation = generation
        self.client_nonce = client_nonce
        self.server_nonce = server_nonce
        self.issued_at = now


class SessionTable:
    """gateway id -> Session, plus the small active set (module doc)."""

    def __init__(self, park_after_s: float = 1.0,
                 clock=time.perf_counter):
        self.park_after_s = park_after_s
        self.clock = clock
        self.sessions: Dict[int, Session] = {}
        self.active: Set[int] = set()
        self.handshakes_ok = 0
        self.sessions_evicted = 0

    def __len__(self) -> int:
        return len(self.sessions)

    @property
    def parked(self) -> int:
        return len(self.sessions) - len(self.active)

    def establish(self, gateway_id: int, generation: int, conn_id: int,
                  now: Optional[float] = None) -> Session:
        """Create (or re-key — a reconnecting gateway re-authenticates
        and the fresh token supersedes the old connection's) the
        session after a verified handshake."""
        if now is None:
            now = self.clock()
        s = Session(gateway_id, generation, auth.new_nonce(), conn_id, now)
        self.sessions[gateway_id] = s
        self.handshakes_ok += 1
        return s

    def lookup(self, gateway_id: int) -> Optional[Session]:
        return self.sessions.get(gateway_id)

    def drop(self, gateway_id: int) -> None:
        """Remove one session (G_BYE, or its connection closed)."""
        self.sessions.pop(gateway_id, None)
        self.active.discard(gateway_id)

    def touch(self, s: Session, now: float) -> None:
        """Traffic on a session: unpark it (O(1))."""
        s.last_seen = now
        self.active.add(s.gateway_id)

    def park_idle(self, now: Optional[float] = None) -> int:
        """Move sessions idle past `park_after_s` out of the active set;
        scans only the ACTIVE set. Returns how many were parked."""
        if now is None:
            now = self.clock()
        cutoff = now - self.park_after_s
        idle = [g for g in self.active
                if (s := self.sessions.get(g)) is None
                or (s.last_seen < cutoff and s.pending == 0)]
        for g in idle:
            self.active.discard(g)
        return len(idle)

    def evict_generation(self, member, generation) -> int:
        """Roster change: drop sessions whose slot was retired or
        re-tenanted (their credentials are stale by construction —
        auth.py binds the key to the generation). Returns evictions."""
        gone = [g for g, s in self.sessions.items()
                if g >= len(member) or not member[g]
                or int(generation[g]) != s.generation]
        for g in gone:
            del self.sessions[g]
            self.active.discard(g)
        self.sessions_evicted += len(gone)
        return len(gone)

    def stats(self) -> Dict:
        return {
            "sessions": len(self.sessions),
            "active": len(self.active),
            "parked": self.parked,
            "handshakes_ok": self.handshakes_ok,
            "sessions_evicted": self.sessions_evicted,
        }
