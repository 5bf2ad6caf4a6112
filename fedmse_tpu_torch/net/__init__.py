"""Network serving plane: the process and network boundary around the
serving engines (port of fedmse_tpu/net/).

  wire.py       length-prefixed binary TCP frames that deserialize
                straight into submit_many's contiguous burst shape, byte
                for byte the JAX package's frames; explicit per-row
                terminal statuses (normal / anomaly / SHED /
                UNKNOWN_GATEWAY, never a silent drop)
  admission.py  tiered load shedding: a token bucket refilled at the
                MEASURED fleet capacity sheds lowest-priority rows first,
                only under sustained overload; per-session isolation
  router.py     N engine replicas (in-process, each on a CUDA stream of
                its own, or remote worker processes) behind one
                roster-aware router: retired gateways terminate AT the
                router, admitted bursts stripe across replicas in
                contiguous max_batch slices, hot swaps broadcast with
                per-replica regime atomicity
  autoscale.py  SLO-driven scaling: replica count and bucket size from
                the p99 budget and a per-backend cost model
  server.py     asyncio NetFront: socket -> router -> streamed RESULT
                frames; one event loop owns every replica batcher;
                `python -m fedmse_tpu_torch.net.server` is the worker
  client.py     open-loop blocking NetClient and RemoteReplica (a worker
                process as a router stripe target; swaps cross the wire
                as numpy only)
  smoke.py      the end-to-end pass over a checkpointed federation,
                wired to `fedmse_tpu_torch.main --serve-net`
"""

from fedmse_tpu_torch.net.admission import AdmissionController
from fedmse_tpu_torch.net.autoscale import (BackendSpec, ScaleDecision,
                                            SLOAutoscaler)
from fedmse_tpu_torch.net.client import NetClient, RemoteReplica
from fedmse_tpu_torch.net.router import (LocalReplica, RouteResult, Router,
                                         make_local_replicas)
from fedmse_tpu_torch.net.server import FrontHandle, NetFront
from fedmse_tpu_torch.net.smoke import run_net_smoke
from fedmse_tpu_torch.net.wire import (STATUS_ANOMALY, STATUS_NAMES,
                                       STATUS_NORMAL, STATUS_SHED,
                                       STATUS_UNKNOWN_GATEWAY)

__all__ = [
    "AdmissionController",
    "BackendSpec",
    "ScaleDecision",
    "SLOAutoscaler",
    "NetClient",
    "RemoteReplica",
    "LocalReplica",
    "RouteResult",
    "Router",
    "make_local_replicas",
    "FrontHandle",
    "NetFront",
    "run_net_smoke",
    "STATUS_ANOMALY",
    "STATUS_NAMES",
    "STATUS_NORMAL",
    "STATUS_SHED",
    "STATUS_UNKNOWN_GATEWAY",
]
