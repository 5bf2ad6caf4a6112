"""fedmse_tpu_torch.gateway: the secure, multiplexed ingest plane (port of
fedmse_tpu/gateway/).

The net plane (fedmse_tpu_torch/net/) is a trusted-backend protocol
between co-deployed processes; this package is what stands between it and
the open internet at the million-gateway scale:

  mux.py       session-multiplexed wire format (many gateways per TCP
               connection; identity in every frame header)
  auth.py      KDF-per-device keys + HMAC challenge-response handshake
  tls.py       optional TLS underneath (stdlib ssl + openssl-CLI certs)
  session.py   the frontend's session table (active set / parked mass)
  stripe.py    FailoverStripe — admitted tickets survive replica death
  frontend.py  the epoll ingest loop: handshakes + admission up front,
               scoring striped to net-plane replicas behind a Router
  client.py    GatewayClient — the concentrator / load-generator side

Frames, keys and MACs are the JAX package's bytes; its adversarial half
is redteam/ingest.py.
"""

from fedmse_tpu_torch.gateway.client import (GatewayClient,
                                             GatewayClientError)
from fedmse_tpu_torch.gateway.frontend import (FrontendHandle,
                                               GatewayFrontend,
                                               build_synthetic_frontend)
from fedmse_tpu_torch.gateway.session import Session, SessionTable
from fedmse_tpu_torch.gateway.stripe import FailoverStripe, StripeExhausted

__all__ = [
    "GatewayClient", "GatewayClientError", "FrontendHandle",
    "GatewayFrontend", "build_synthetic_frontend", "Session",
    "SessionTable", "FailoverStripe", "StripeExhausted",
]
