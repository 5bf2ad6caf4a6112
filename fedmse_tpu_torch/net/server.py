"""Asyncio TCP front: NIC batches -> router -> streamed verdicts (port of
fedmse_tpu/net/server.py).

`NetFront` is an asyncio server whose connection readers land each SUBMIT
frame's row block STRAIGHT into the router's burst path
(`Router.submit_many` -> replica `ContinuousBatcher.submit_many`
contiguous slices) and stream RESULT frames back against the O(1)
`TicketBlock` handles as batches harvest.

Concurrency model: ONE event loop owns the router and every replica
batcher (the continuous front is single-threaded by design). A bucket's
dispatch enqueues its copies and kernels on the replica's CUDA stream and
returns (router.py), so the loop's drive task interleaves socket reads,
`router.poll()` harvests and result writes without locks. The loop may
run on another thread than the one that built the engines
(`FrontHandle`): every dispatch and harvest is issued from the loop's
thread, on the replicas' own streams. The drive task finalizes completed
RouteResults in arrival order per connection and flushes them with
vectorized packs (one write per request, never per row).

A SWAP frame's payload is placed on an executor thread
(`_prepare_swap_payload`): its host arrays go to the device and compute
dtype of the front's local engines, and the copies are synchronized
before the loop installs them, so the install copies nothing and every
replica stream reads the whole payload.

Autoscaling rides the same loop: with an `SLOAutoscaler` + a
`replica_factory` installed, a periodic tick feeds the admission
controller's arrival EMA and the fleet's worst p99 into the policy and
applies its decisions: resizing every replica's bucket and
adding/removing `LocalReplica`s (removal drains the replica first, so
scale-down strands no ticket).

`python -m fedmse_tpu_torch.net.server --port P --replicas R [--device
cpu] ...` serves a synthetic federation standalone: the replica worker
(a worker is a NetFront whose router has one local replica;
client.RemoteReplica makes it a stripe target of a front-tier router).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.net import wire
from fedmse_tpu_torch.net.router import Router

logger = logging.getLogger(__name__)


_DRAIN_AT = 8 * 1024 * 1024  # write-buffer bytes before an awaited drain


def _write_buffer(conn) -> int:
    try:
        return conn.writer.transport.get_write_buffer_size()
    except Exception:
        return 0


class _Conn:
    __slots__ = ("writer", "pending", "unsent")

    def __init__(self, writer):
        self.writer = writer
        self.pending: List = []    # (request_id, RouteResult) FIFO
        self.unsent = 0


class NetFront:
    """The network serving plane's front process (module docstring)."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, autoscaler=None,
                 replica_factory: Optional[Callable[[int], object]] = None,
                 backend_name: str = "cpu",
                 autoscale_interval_s: float = 1.0,
                 idle_sleep_s: float = 0.0005):
        self.router = router
        self.host = host
        self.port = port          # 0 = ephemeral; real port after start()
        self.autoscaler = autoscaler
        self.replica_factory = replica_factory
        # the backend every LOCAL replica (and the factory's output)
        # belongs to — live apply is single-backend; see _autoscale_tick
        self.backend_name = backend_name
        self.autoscale_interval_s = autoscale_interval_s
        self.idle_sleep_s = idle_sleep_s
        self.autoscale_events: List[Dict] = []
        self._conns: List[_Conn] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._drive_task: Optional[asyncio.Task] = None
        self._stopping = False
        self.requests = 0
        self.results_sent = 0

    # ----------------------------- lifecycle ------------------------------ #

    async def start(self) -> None:
        # limit: the StreamReader's internal buffer. The default 64 KiB
        # pauses/resumes the transport several times per NIC-batch frame
        # (a 2048-row SUBMIT is ~1 MB); size it for a handful of full
        # frames.
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=16 * 1024 * 1024)
        self.port = self._server.sockets[0].getsockname()[1]
        self._drive_task = asyncio.ensure_future(self._drive())
        logger.info("net front listening on %s:%d (%d replica(s))",
                    self.host, self.port, len(self.router.replicas))

    async def aclose(self) -> None:
        self._stopping = True
        if self._drive_task is not None:
            self._drive_task.cancel()
            try:
                await self._drive_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.router.drain()
        await self._flush_completed(force_drain=True)
        for conn in list(self._conns):
            try:
                conn.writer.close()
            except Exception:
                pass

    # ----------------------------- drive loop ----------------------------- #

    async def _drive(self) -> None:
        next_scale = (asyncio.get_event_loop().time()
                      + self.autoscale_interval_s)
        while not self._stopping:
            busy = self.router.poll()
            sent = await self._flush_completed()
            if self.autoscaler is not None:
                now = asyncio.get_event_loop().time()
                if now >= next_scale:
                    next_scale = now + self.autoscale_interval_s
                    self._autoscale_tick()
            if busy or sent:
                await asyncio.sleep(0)       # yield to socket readers
            else:
                await asyncio.sleep(self.idle_sleep_s)

    async def _flush_completed(self, force_drain: bool = False) -> int:
        """Send RESULT frames for every completed pending RouteResult
        (per connection, in arrival order — a completed result behind an
        incomplete one waits, so each connection's responses arrive in
        its own submit order)."""
        sent = 0
        for conn in self._conns:
            while conn.pending:
                request_id, res = conn.pending[0]
                if not res.finalize():
                    break
                conn.pending.pop(0)
                try:
                    conn.writer.write(wire.pack_result(
                        request_id, res.statuses, res.scores))
                    conn.unsent += 1
                except (ConnectionError, RuntimeError):
                    conn.pending.clear()
                    break
                sent += 1
                self.results_sent += 1
            # drain only when a connection's write buffer is genuinely
            # large (results are ~5 bytes/row, so this is rare): an
            # unconditional drain would suspend the WHOLE drive loop on
            # the slowest reader — one stalled client must never stop
            # the fleet's harvesting. NetClient's non-blocking _send
            # guarantees a live client eventually reads.
            if conn.unsent and (force_drain or _write_buffer(conn) > _DRAIN_AT):
                try:
                    await conn.writer.drain()
                except (ConnectionError, RuntimeError):
                    pass
                conn.unsent = 0
        return sent

    def _autoscale_tick(self) -> None:
        """One live scaling tick. Live apply is SINGLE-BACKEND: every
        replica this front owns (and everything `replica_factory`
        creates) is a `backend_name` replica, so `current` reports the
        fleet under that one name — accurate supply accounting — and
        only the decision's `backend_name` share is applied here. A
        multi-backend decision's other shares stay in the decision
        trace (`autoscaler.stats()`/`autoscale_events`): provisioning
        an accelerator replica is an out-of-band deployment action,
        not something a running front can conjure (ROADMAP notes the
        live cross-backend apply as open headroom)."""
        adm = self.router.admission
        arrival = (adm.arrival_rate_rows_per_sec
                   if adm is not None else 0.0)
        st = self.router.stats()
        n_before = len(self.router.replicas)
        current = {self.backend_name: n_before}
        d = self.autoscaler.decide(
            arrival_rows_per_sec=arrival,
            p99_ms=st["latency_p99_ms_worst"], current=current)
        if d.action == "hold":
            return
        applied = {"action": d.action, "reason": d.reason,
                   "bucket": d.bucket, "decided_mix": dict(d.replicas)}
        want = d.replicas.get(self.backend_name, n_before)
        unapplied = {k: v for k, v in d.replicas.items()
                     if k != self.backend_name and v > 0}
        if unapplied:
            logger.warning(
                "autoscale decision wants %s replicas this front cannot "
                "create (single-backend live apply, backend %r); "
                "provision them out-of-band", unapplied, self.backend_name)
        if self.replica_factory is not None:
            while len(self.router.replicas) < want:
                self.router.replicas.append(
                    self.replica_factory(len(self.router.replicas)))
            while len(self.router.replicas) > max(1, want):
                gone = self.router.replicas.pop()
                gone.drain()   # scale-down strands no ticket
        # resize AFTER any membership change, so freshly appended
        # replicas get the decided bucket too (not the factory default)
        for rep in self.router.replicas:
            if hasattr(rep, "resize"):
                rep.resize(d.bucket)
        if adm is not None and adm.capacity_rows_per_sec is not None:
            # capacity tracks the fleet: scale the bucket rate with the
            # replica count change (a fresh calibration probe would be
            # exact; proportional keeps the tick non-blocking)
            adm.set_capacity(adm.capacity_rows_per_sec
                             * len(self.router.replicas)
                             / max(1, n_before))
        self.autoscaler.mark_applied()
        applied["replicas_now"] = len(self.router.replicas)
        if unapplied:
            applied["unapplied_mix"] = unapplied
        self.autoscale_events.append(applied)
        logger.info("autoscale: %s", applied)

    # ----------------------------- connections ---------------------------- #

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        self._conns.append(conn)
        try:
            while True:
                try:
                    head = await reader.readexactly(4)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                (n,) = wire._LEN.unpack(head)
                if n > wire.MAX_FRAME:
                    writer.write(wire.pack_control(
                        wire.MSG_ERROR, 0,
                        f"frame length {n} exceeds MAX_FRAME".encode()))
                    break
                payload = memoryview(await reader.readexactly(n))
                msg_type, request_id = wire.parse_header(payload)
                if msg_type == wire.MSG_SUBMIT:
                    # zero-copy views: this payload is a fresh bytes
                    # object per frame, and the replicas' intake copies
                    # whatever lands in a forming window — one row copy
                    # per burst, total
                    rid, rows, gws, tiers, t_sent = \
                        wire.unpack_submit(payload, copy=False)
                    self.requests += 1
                    # age = how long the burst already queued (kernel RX
                    # + reader backlog) — admission's staleness signal.
                    # Clamp at 0: a peer clock slightly ahead must not
                    # turn into negative age (never into shedding).
                    age = max(0.0, time.time() - t_sent)
                    res = self.router.submit_many(rows, gws, tiers,
                                                  age_s=age)
                    conn.pending.append((rid, res))
                elif msg_type == wire.MSG_SWAP:
                    # unpickle + device-place the payload on an executor
                    # thread: placing a params tree inline would stall
                    # every replica's harvest loop. The loop-side swap
                    # below then only re-validates and flips pointers
                    # (the placed tensors are installed as they are)
                    rid = wire.parse_header(payload)[1]
                    loop = asyncio.get_event_loop()
                    payload_dict = await loop.run_in_executor(
                        None, _prepare_swap_payload,
                        bytes(wire.body(payload)), self._placement())
                    try:
                        event = self.router.swap(**payload_dict)
                    except (ValueError, TypeError) as e:
                        # a rejected payload (foreign federation, empty
                        # swap) is the CALLER's error: report it on the
                        # wire and keep serving — traffic is unaffected
                        writer.write(wire.pack_control(
                            wire.MSG_ERROR, rid,
                            f"swap rejected: {e}".encode()))
                        await writer.drain()
                        continue
                    writer.write(wire.pack_control(
                        wire.MSG_SWAP_ACK, rid,
                        json.dumps(_json_safe(event)).encode()))
                    await writer.drain()
                elif msg_type == wire.MSG_STATS:
                    st = self.stats()
                    writer.write(wire.pack_control(
                        wire.MSG_STATS_REPLY, request_id,
                        json.dumps(_json_safe(st)).encode()))
                    await writer.drain()
                elif msg_type == wire.MSG_CLOSE:
                    break
                else:
                    writer.write(wire.pack_control(
                        wire.MSG_ERROR, request_id,
                        f"unknown msg_type {msg_type}".encode()))
                    break
        except Exception:
            logger.exception("net front connection failed")
            try:
                writer.write(wire.pack_control(
                    wire.MSG_ERROR, 0, b"internal error; closing"))
                await writer.drain()
            except Exception:
                pass
        finally:
            # the connection's in-flight work still completes inside the
            # replicas (tickets are never dropped); only the responses
            # have nowhere to go
            self._conns.remove(conn)
            try:
                writer.close()
            except Exception:
                pass

    def _placement(self):
        """(device, compute dtype) of the front's local engines, or None
        when every replica is remote (the payload then stays host
        arrays and each worker places it)."""
        for rep in self.router.replicas:
            eng = getattr(rep, "engine", None)
            if eng is not None:
                return eng.device, eng.policy.compute_dtype
        return None

    def stats(self) -> Dict:
        out = {"front": "net", "host": self.host, "port": self.port,
               "requests": self.requests,
               "results_sent": self.results_sent,
               "connections": len(self._conns),
               "router": self.router.stats(),
               "autoscale_events": self.autoscale_events}
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out


def _prepare_swap_payload(body: bytes, placement) -> Dict:
    """Executor-side half of a wire swap: unpickle the host payload
    (client.host_payload) and place its arrays on `placement`'s device
    and compute dtype (params through params_from_numpy; banks and
    centroid statistics f32), the engines' own placement, so the
    loop-side install copies nothing. On the card the placing stream is
    synchronized before the payload is returned: a replica stream does not
    order itself after it, and must read the copies whole."""
    import pickle

    import torch

    from fedmse_tpu_torch.models.autoencoder import params_from_numpy
    from fedmse_tpu_torch.models.centroid import CentroidClassifier

    payload = pickle.loads(body)
    if placement is None:
        return payload
    device, dtype = placement
    if payload.get("params") is not None:
        payload["params"] = params_from_numpy(payload["params"], device,
                                              dtype)
    cen = payload.get("centroids")
    if cen is not None:
        payload["centroids"] = CentroidClassifier(*(
            torch.as_tensor(getattr(cen, f.name)).to(device, torch.float32)
            for f in dataclasses.fields(cen)))
    if payload.get("banks") is not None:
        payload["banks"] = payload["banks"].to(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return payload


def _json_safe(obj):
    """Recursively coerce numpy scalars/arrays and NaN for strict JSON."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_safe(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        f = float(obj)
        return f if np.isfinite(f) else None
    return obj


class FrontHandle:
    """A NetFront running on its own event-loop thread (the embedding
    used by the driver's --serve-net pass, the tests and chip_smoke.py):
    `port` is live after construction, `stop()` joins cleanly."""

    def __init__(self, front: NetFront):
        self.front = front
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="net-front")
        self._thread.start()
        if not self._started.wait(30.0):
            raise RuntimeError("net front failed to start within 30 s")

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self.front.start())
        self._started.set()
        self._loop.run_forever()
        self._loop.run_until_complete(self.front.aclose())
        self._loop.close()

    @property
    def port(self) -> int:
        return self.front.port

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(30.0)


# ------------------------ synthetic deployment ------------------------- #

def build_synthetic_replicas(n_gateways: int = 10, dim: int = 115,
                             replicas: int = 2, max_batch: int = 1024,
                             latency_budget_ms: float = 25.0,
                             seed: int = 0, model_type: str = "hybrid",
                             warmup: bool = True,
                             return_factory: bool = False,
                             device: DeviceLike = "cuda"):
    """The replica-fleet half of the synthetic deployment: warmed
    LocalReplicas over paper-dimension models with independent inits and
    a shared calibration, reconstructed from (seed, dims) alone, so the
    net plane's router (build_synthetic_router), the gateway plane's
    FailoverStripe (gateway/frontend.py) and a worker process
    (`python -m fedmse_tpu_torch.net.server`) build the SAME scoring
    fleet, bit for bit. The init draws from a CPU torch.Generator seeded
    with `seed` (the JAX package draws from jax.random.key(seed), which
    the port cannot reproduce); the train and calibration rows are the
    JAX package's numpy draws.

    `return_factory=True` additionally returns a LocalReplica factory
    building warmed replicas of the same deployment (the live
    autoscale-apply hook)."""
    import torch

    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.net.router import LocalReplica, make_local_replicas
    from fedmse_tpu_torch.serving import ServingEngine, fit_calibration

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    model = make_model(model_type, dim, shrink_lambda=10.0, generator=gen,
                       device=dev)
    params = init_stacked_params(model, n_gateways, gen, device=dev)
    train_x = rng.normal(size=(n_gateways, 512, dim)).astype(np.float32)

    def factory(i: int) -> ServingEngine:
        return ServingEngine.from_federation(
            model, model_type, params,
            train_x=train_x if model_type == "hybrid" else None,
            max_bucket=max_batch, device=dev)

    engine0 = factory(0)
    calibration = fit_calibration(
        engine0, rng.normal(size=(n_gateways, 256, dim)).astype(np.float32))
    reps = [engine0] + [factory(i) for i in range(1, replicas)]
    if warmup:
        for e in reps:
            e.warmup()
    local = make_local_replicas(lambda i: reps[i], replicas,
                                max_batch=max_batch,
                                latency_budget_ms=latency_budget_ms,
                                calibration=calibration)
    if not return_factory:
        return local

    def replica_factory(i: int) -> LocalReplica:
        eng = factory(i)
        if warmup:
            eng.warmup()  # a scale-up must not build its buckets mid-load
        return LocalReplica(eng, max_batch=max_batch,
                            latency_budget_ms=latency_budget_ms,
                            calibration=calibration, name=f"replica{i}")

    return local, replica_factory


def build_synthetic_router(n_gateways: int = 10, dim: int = 115,
                           replicas: int = 2, max_batch: int = 1024,
                           latency_budget_ms: float = 25.0,
                           tiers: int = 3, seed: int = 0,
                           model_type: str = "hybrid",
                           headroom: float = 0.9,
                           calibrate: bool = True,
                           warmup: bool = True,
                           return_factory: bool = False,
                           device: DeviceLike = "cuda"):
    """A self-contained serving plane over a synthetic federation:
    build_synthetic_replicas wrapped in a Router + admission. Scoring
    throughput does not depend on training quality, so this is the
    deployment every worker process reconstructs from the (seed, dims)
    tuple alone.

    `return_factory=True` additionally returns the LocalReplica factory
    (`NetFront(replica_factory=...)` — live autoscale apply grows the
    fleet through _autoscale_tick)."""
    built = build_synthetic_replicas(
        n_gateways=n_gateways, dim=dim, replicas=replicas,
        max_batch=max_batch, latency_budget_ms=latency_budget_ms,
        seed=seed, model_type=model_type, warmup=warmup,
        return_factory=return_factory, device=device)
    local, replica_factory = built if return_factory else (built, None)
    from fedmse_tpu_torch.net.admission import AdmissionController
    router = Router(local, admission=AdmissionController(
        tiers=tiers, headroom=headroom,
        stale_after_s=latency_budget_ms / 1000.0))
    if calibrate:
        rng = np.random.default_rng(seed + 1)  # probe values are inert
        probe = rng.normal(size=(max_batch, dim)).astype(np.float32)
        probe_g = rng.integers(0, n_gateways, max_batch).astype(np.int32)
        router.calibrate_capacity(probe, probe_g)
    if not return_factory:
        return router
    return router, replica_factory


def main(argv=None) -> None:
    """Standalone synthetic serving plane (worker/demo entry)."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--gateways", type=int, default=10)
    p.add_argument("--dim", type=int, default=115)
    p.add_argument("--max-batch", type=int, default=1024)
    p.add_argument("--budget-ms", type=float, default=25.0)
    p.add_argument("--tiers", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    p.add_argument("--model-type", default="hybrid",
                   choices=["hybrid", "autoencoder"],
                   help="per-gateway scorer; 'autoencoder' skips the "
                        "kNN bank and is the only tractable choice for "
                        "100k+-gateway single-host workers")
    p.add_argument("--no-admission", action="store_true",
                   help="serve without a capacity bucket (a replica "
                        "worker behind a front-tier router: the FRONT "
                        "owns admission, workers must not double-shed)")
    p.add_argument("--autoscale", action="store_true",
                   help="attach the SLO autoscaler (net/autoscale.py) "
                        "with LIVE apply: the drive loop's scale ticks "
                        "add/remove warmed local replicas and resize "
                        "buckets through the replica factory; every "
                        "decision + what was actually applied lands in "
                        "stats()['autoscale_events']")
    p.add_argument("--autoscale-max-replicas", type=int, default=4)
    p.add_argument("--autoscale-interval-s", type=float, default=0.5)
    p.add_argument("--autoscale-target-util", type=float, default=0.6,
                   help="supply is kept at demand/target_utilization; "
                        "scale-down engages below a third of it")
    p.add_argument("--autoscale-cooldown-s", type=float, default=3.0,
                   help="hysteresis after an applied change — must ride "
                        "out the arrival-EMA dip a scale-up's replica "
                        "warmup causes on a busy box")
    p.add_argument("--autoscale-capacity-derate", type=float, default=1.0,
                   help="multiply the calibration-probed per-replica "
                        "capacity by this fraction in the autoscaler's "
                        "supply model: the probe runs against a "
                        "QUIESCENT server, and effective capacity under "
                        "concurrent load generators / co-located "
                        "processes is lower (the same overstatement "
                        "sequential probes have — admission.py)")
    args = p.parse_args(argv)

    # the kernels load from the hash-named build cache (ops/native.py): a
    # worker spawned after its parent built them compiles nothing
    router, replica_factory = build_synthetic_router(
        n_gateways=args.gateways, dim=args.dim, replicas=args.replicas,
        max_batch=args.max_batch, latency_budget_ms=args.budget_ms,
        tiers=args.tiers, seed=args.seed, model_type=args.model_type,
        calibrate=not args.no_admission, return_factory=True,
        device=args.device)
    if args.no_admission:
        router.admission = None
    autoscaler = None
    if args.autoscale:
        from fedmse_tpu_torch.net.autoscale import BackendSpec, SLOAutoscaler
        adm = router.admission
        # per-replica supply from the calibration probe (measured, not
        # modeled): the probed bucket rate is the fleet's, split evenly
        per_replica = ((adm.capacity_rows_per_sec / len(router.replicas))
                       if adm is not None
                       and adm.capacity_rows_per_sec else 50_000.0)
        per_replica *= args.autoscale_capacity_derate
        autoscaler = SLOAutoscaler(
            budget_ms=args.budget_ms,
            backends=[BackendSpec(resolve_device(args.device).type,
                                  rows_per_sec=per_replica,
                                  usd_per_hour=0.10,
                                  max_replicas=args.autoscale_max_replicas)],
            min_bucket=64, max_bucket=args.max_batch,
            target_utilization=args.autoscale_target_util,
            scale_down_utilization=args.autoscale_target_util / 3.0,
            cooldown_s=args.autoscale_cooldown_s)

    async def run():
        front = NetFront(router, host=args.host, port=args.port,
                         autoscaler=autoscaler,
                         backend_name=resolve_device(args.device).type,
                         replica_factory=(replica_factory
                                          if args.autoscale else None),
                         autoscale_interval_s=args.autoscale_interval_s)
        await front.start()
        # SIGTERM is the parent's "stop": the front closes (in-flight
        # work completes) and the process exits 0
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      stop.set)
        print(json.dumps({"listening": True, "host": args.host,
                          "port": front.port,
                          "replicas": len(router.replicas)}), flush=True)
        try:
            await stop.wait()
        finally:
            await front.aclose()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
