"""TLS on the ingest wire: contexts + a zero-dependency cert path.

The gateway plane's identity layer is the HMAC handshake (auth.py) —
it proves WHICH gateway is talking and is mandatory. TLS adds what the
MAC cannot: confidentiality and integrity for the row bytes in transit
and server authentication (a gateway knows it reached the real
frontend before offering its transcript). The two compose; neither
substitutes for the other.

No `cryptography`/pyOpenSSL dependency enters the repo: certificates
come from the `openssl` CLI (present on every deployment image this
repo targets; `have_openssl()` gates the benches so a stripped
container degrades to tls=off loudly, never silently). Dev/bench certs
are self-signed ECDSA P-256 — an EC key keeps the per-connection
handshake CPU ~an order of magnitude under RSA-2048, which matters
when one frontend terminates thousands of handshakes on a CPU core
(the bench's tls cell measures exactly this).

Server contexts require TLS1.2+; client contexts pin the provided CA
(the self-signed cert doubles as its own CA in the dev path) and
verify hostname=False — gateways dial frontends by address from their
enrollment config, not by DNS name, so the binding that matters is
key-to-roster (the enrollment handshake), not name-to-key.
"""

from __future__ import annotations

import os
import shutil
import ssl
import subprocess
from typing import Optional, Tuple


class TLSUnavailable(RuntimeError):
    """openssl CLI missing — cert generation impossible on this host."""


def have_openssl() -> bool:
    return shutil.which("openssl") is not None


def ensure_self_signed(cert_dir: str, name: str = "gateway",
                       days: int = 30) -> Tuple[str, str]:
    """(cert_path, key_path): generate a self-signed ECDSA P-256 pair
    under `cert_dir` if absent, reuse it if present (benches and the
    worker processes they spawn share one pair through the dir)."""
    cert = os.path.join(cert_dir, f"{name}.crt")
    key = os.path.join(cert_dir, f"{name}.key")
    if os.path.exists(cert) and os.path.exists(key):
        return cert, key
    if not have_openssl():
        raise TLSUnavailable(
            "no openssl CLI on PATH; provision certificates out-of-band "
            "or run the plane with tls=off")
    os.makedirs(cert_dir, exist_ok=True)
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
         "ec_paramgen_curve:prime256v1", "-keyout", key, "-out", cert,
         "-days", str(days), "-nodes", "-subj",
         "/CN=fedmse-gateway-frontend"],
        check=True, capture_output=True)
    return cert, key


def server_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_context(ca_path: Optional[str] = None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.check_hostname = False  # address-dialed; binding is key-to-roster
    if ca_path is not None:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca_path)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
