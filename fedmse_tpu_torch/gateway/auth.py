"""Per-gateway identity: derived keys + the challenge-response MAC.

Threat model (DESIGN.md §22): the ingest plane terminates the open
internet, so the peer claiming to be gateway g must PROVE it holds g's
enrollment secret before a single row byte of its traffic is parsed,
and the proof must be bound to the roster's view of the slot — a
retired tenant's credentials (stale generation) fail exactly like a
forged id.

Key discipline: the fleet holds ONE master secret; gateway g at tenant
generation t is provisioned `gateway_key(master, g, t)` at enrollment.
Frontends derive the same key on demand (one HMAC), so authenticating
1M gateways needs no 1M-entry key table and a roster generation bump
revokes a slot's old credentials with zero key distribution. This is
the standard KDF-per-device scheme (e.g. LoRaWAN/MQTT fleet keying);
everything is stdlib `hmac`/`hashlib`/`secrets` — no new dependency.

The handshake tag (session_mac) covers gateway id, generation, and
BOTH nonces, so a transcript cannot be replayed against a different
slot, a different tenancy, or a different handshake. Verification is
`hmac.compare_digest` — constant-time, like every token check in the
plane.

The master key is secret MATERIAL, not configuration: `master_key()`
accepts an explicit hex string (deployments load it from their secret
store) and otherwise derives a deterministic DEV key from the
experiment seed — good for benches/tests where both ends are built
from one config, loudly not for production (the derivation is public).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import struct

from fedmse_tpu_torch.gateway.mux import MAC_LEN, NONCE_LEN

_KEY_INFO = b"fedmse-gateway-key-v1"
_MAC_INFO = b"fedmse-gateway-auth-v1"
_DEV_INFO = b"fedmse-gateway-DEV-master-v1"


def master_key(key_hex: str = "", seed: int = 0) -> bytes:
    """The fleet master secret: `key_hex` verbatim when provided (the
    deployment path), else a seed-derived DEV key (the bench/test
    path — deterministic and PUBLIC, never production material)."""
    if key_hex:
        key = bytes.fromhex(key_hex)
        if len(key) < 16:
            raise ValueError("gateway master key must be >= 16 bytes")
        return key
    return hashlib.sha256(_DEV_INFO + struct.pack("!q", seed)).digest()


def gateway_key(master: bytes, gateway_id: int, generation: int) -> bytes:
    """The per-gateway enrollment secret (module docstring)."""
    msg = _KEY_INFO + struct.pack("!IQ", gateway_id, generation)
    return hmac.new(master, msg, hashlib.sha256).digest()


def new_nonce() -> bytes:
    return secrets.token_bytes(NONCE_LEN)


def session_mac(key: bytes, gateway_id: int, generation: int,
                client_nonce: bytes, server_nonce: bytes) -> bytes:
    """The G_AUTH transcript tag: binds identity, tenancy, and both
    nonces under the gateway's enrollment key."""
    msg = (_MAC_INFO + struct.pack("!IQ", gateway_id, generation)
           + client_nonce + server_nonce)
    mac = hmac.new(key, msg, hashlib.sha256).digest()
    assert len(mac) == MAC_LEN
    return mac


def verify_session_mac(key: bytes, gateway_id: int, generation: int,
                       client_nonce: bytes, server_nonce: bytes,
                       mac: bytes) -> bool:
    return hmac.compare_digest(
        session_mac(key, gateway_id, generation, client_nonce,
                    server_nonce), mac)
