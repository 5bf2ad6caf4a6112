"""Bucketed multi-tenant anomaly scorer (port of fedmse_tpu/serving/engine.py).

  * **Buckets**: requests pad up to the next rung of a row-bucket ladder
    (powers of two up to max_bucket) and larger requests are chunked at
    max_bucket. Eager PyTorch compiles nothing per shape; the ladder stays
    so that one bucket is one fixed-shape launch, the unit a later CUDA
    graph captures. Padding rows are dropped after the launch; the score
    math is per row, so they cannot perturb real rows.
  * **Every score goes through the fused kernel** (ops/fused_ae.py): one
    launch per bucket, each row routed to its gateway's model by the
    kernel's per-row model index (multi-tenant) or all rows on model 0
    (single-global). `routing` keeps the JAX engine's options: 'gather'
    and 'dense' both resolve to that one launch.
  * **Score parity**: AE-MSE straight from the kernel; hybrid centroid
    density of the kernel's latent against the row's gateway centroid; kNN
    k-th distance of the kernel's latent to the row's gateway bank (one
    launch of the distance kernel per bucket, knn/score.py); the
    evaluator's nan_to_num guard. `make_evaluate_all(..., metric="scores")`
    is the oracle.
  * **State as an operand**: the resident state {params, centroids, banks}
    is one dict handed to each launch, so `swap_state` is one rebind
    between dispatches and a dispatched bucket keeps the state it was
    launched with. A bank swap may change the bank capacity B, never L.
  * **Dispatch / harvest**: `dispatch` stages the rows in pinned host
    memory, copies them to the card, launches, and starts a non-blocking
    copy of the scores into pinned memory followed by a CUDA event;
    `PendingScores.is_ready` is the event's query and `harvest` waits on
    it.

  * **Mesh** (`mesh=` a parallel.ClientMesh of W > 1 ranks): when W
    divides the gateway count each rank holds the block of params,
    centroids and banks of the gateways it owns
    (parallel.mesh.process_client_rows), else every rank holds the whole
    state. A `score` / `dispatch` on a gateway-sharded engine is
    collective: every rank is handed the same rows and scores the whole
    bucket against its block (a row of another rank's gateway is routed
    to a local model and dropped), the ranks' scores are gathered, and
    each row takes its owner's. The kernels are per-row, so in f32 a row
    is the unsharded engine's bits. Every rank must dispatch the same
    buckets in the same order: the continuous front's timer flushes
    differ across ranks, so over a sharded engine it runs with a latency
    budget no flush reaches (a flush on size only).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.evaluation.evaluator import resolve_score_kind
from fedmse_tpu_torch.knn.bank import ReferenceBank, build_banks
from fedmse_tpu_torch.knn.score import knn_kth_distance, routed_kth_distance
from fedmse_tpu_torch.models.autoencoder import params_from_numpy
from fedmse_tpu_torch.models.centroid import CentroidClassifier, fit_centroid
from fedmse_tpu_torch.ops.fused_ae import encode_rows, fused_forward_stats
from fedmse_tpu_torch.ops.precision import PrecisionPolicy, get_policy

logger = logging.getLogger(__name__)


class UnknownGatewayError(ValueError):
    """A request routed to a gateway slot that is not currently a member of
    the federation (left, or never joined). Raised at dispatch validation:
    the launch itself would score the row against whatever model the slot
    holds. The serving verdict for such a row is UNKNOWN_GATEWAY."""

    verdict = "UNKNOWN_GATEWAY"


@dataclasses.dataclass(frozen=True)
class ServingRoster:
    """Which gateway slots are occupied, and by which tenant generation.
    Host-side metadata, installed at build (`roster=`) or swapped between
    dispatches (`swap_state(roster=)`, `ContinuousBatcher.swap(roster=)`).

    `cluster` (optional [N] int32, cluster/) records which cluster model
    each slot serves under a clustered federation. The routing itself is
    already in the stacked params (gateway g's row is its cluster's model,
    cluster.cluster_models), so the column is provenance the swap carries
    and checks, not a dispatch path: membership, not clustering, decides
    UNKNOWN_GATEWAY."""

    member: np.ndarray      # [N] bool — slot currently serves a tenant
    generation: np.ndarray  # [N] int64 — tenant generation per slot
    cluster: Optional[np.ndarray] = None  # [N] int32 — cluster per slot

    def __post_init__(self):
        object.__setattr__(self, "member",
                           np.ascontiguousarray(self.member, dtype=bool))
        object.__setattr__(self, "generation",
                           np.ascontiguousarray(self.generation,
                                                dtype=np.int64))
        if self.member.shape != self.generation.shape:
            raise ValueError(
                f"roster member {self.member.shape} and generation "
                f"{self.generation.shape} must describe the same slots")
        if self.cluster is not None:
            object.__setattr__(
                self, "cluster",
                np.ascontiguousarray(self.cluster, dtype=np.int32))
            if self.cluster.shape != self.member.shape:
                raise ValueError(
                    f"roster cluster column {self.cluster.shape} must "
                    f"describe the same slots as member "
                    f"{self.member.shape}")

    @property
    def num_gateways(self) -> int:
        return len(self.member)

    @staticmethod
    def full(n: int) -> "ServingRoster":
        """The static federation's roster: every slot a founding tenant."""
        return ServingRoster(member=np.ones(n, bool),
                             generation=np.zeros(n, np.int64))


class PendingScores:
    """One in-flight bucket: `harvest()` waits for its scores (the launch
    and the copy into pinned host memory) and returns the unpadded float32
    scores."""

    __slots__ = ("take", "_host", "_event", "_out")

    def __init__(self, host: torch.Tensor, take: int,
                 event: Optional[torch.cuda.Event] = None):
        self._host = host
        self._event = event
        self.take = take
        self._out: Optional[np.ndarray] = None

    def is_ready(self) -> bool:
        """True when harvest() would not block."""
        return (self._out is not None or self._event is None
                or self._event.query())

    def harvest(self) -> np.ndarray:
        """Block (if needed) and return the float32 scores [take]."""
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
            self._out = self._host[:self.take].numpy().copy()
            self._host = self._event = None
        return self._out


def _as_rows(t, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                           else t).to(device)


@torch.no_grad()
def fit_gateway_centroids(model, stacked_params, train_x,
                          train_m=None) -> CentroidClassifier:
    """Per-gateway CentroidClassifier, leaves stacked [N, ...]: the
    evaluator's hybrid fit. Each gateway's train rows (batch-major
    [N, NB, B, D] or flat [N, S, D]) encode under its own params in ONE
    fused launch; the centroid fits on the masked latents. Runs on the
    params' device."""
    latent = encode_rows(model, stacked_params, train_x)
    n, s = latent.shape[:2]
    mask = (None if train_m is None
            else _as_rows(train_m, latent.device).reshape(n, s))
    return fit_centroid(latent, mask)


def _leaves(component) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a params tree or a CentroidClassifier, in a fixed
    order: what a hot swap must match."""
    if isinstance(component, CentroidClassifier):
        return [(f.name, getattr(component, f.name))
                for f in dataclasses.fields(component)]
    out = []
    for k in sorted(component):
        v = component[k]
        out += ([(f"{k}/{n}", t) for n, t in _leaves(v)]
                if isinstance(v, dict) else [(k, v)])
    return out


class ServingEngine:
    """Bucketed scorer over a trained federation.

    model: the port's Autoencoder/ShrinkAutoencoder (supplies input_dim
        and the widths). model_type: 'autoencoder' or 'hybrid'.
    params: stacked [N, ...] tree (multi_tenant=True) or one model's tree
        ([in, out] leaves, or stacked with N = 1) for the single-global
        engine; numpy or tensors, f32 masters.
    centroids: CentroidClassifier, required for the centroid score; leaves
        stacked [N, ...] (multi-tenant) or one classifier.
    banks: knn.ReferenceBank, required for the kNN score: [N, B, L] banks
        (multi-tenant) or one bank [1, B, L] (single-global).
    score_kind: 'auto' (autoencoder -> 'mse', hybrid -> 'centroid'),
        'mse', 'centroid' or 'knn'.
    knn_k, knn_topk: the kNN score's k and top-k mode ('exact' | 'approx').
    max_bucket: largest row bucket (rounded up to a power of two); larger
        requests are chunked.
    bucket_ladder: 'auto' (the tuned ladder of the tuning cache, tune/,
        else pow2), 'pow2', or an explicit ascending sequence ending at
        max_bucket.
    precision: 'f32' (the pinned mode) or 'bf16': the resident kernels and
        the staged rows are bf16, biases and centroid statistics f32, every
        score f32.
    routing: 'auto' | 'gather' | 'dense', kept for the JAX engine's API;
        every routing is the one fused launch with per-row model indices.
    roster: optional ServingRoster; rows routed to a slot that is not a
        member fail with UnknownGatewayError.
    device: 'cuda' by default (raises without a card); 'cpu' runs the
        kernel's plain PyTorch version.
    """

    def __init__(self, model, model_type: str, params: Any,
                 centroids: Optional[CentroidClassifier] = None, *,
                 banks: Optional[ReferenceBank] = None,
                 score_kind: str = "auto", knn_k: int = 8,
                 knn_topk: str = "exact", multi_tenant: bool = True,
                 max_bucket: int = 1024,
                 bucket_ladder: Union[str, Sequence[int]] = "auto",
                 precision: Union[str, PrecisionPolicy] = "f32",
                 mesh: Any = None, routing: str = "auto",
                 roster: Optional[ServingRoster] = None,
                 device: DeviceLike = "cuda"):
        if model_type not in ("autoencoder", "hybrid"):
            raise ValueError(f"unknown model_type {model_type!r}")
        score_kind = resolve_score_kind(model_type, score_kind)
        if mesh is not None and not hasattr(mesh, "world_size"):
            raise ValueError(f"mesh must be a parallel.ClientMesh, got "
                             f"{type(mesh).__name__}")
        if score_kind == "centroid" and centroids is None:
            raise ValueError("centroid serving needs fitted centroids "
                             "(fit_gateway_centroids)")
        if score_kind == "knn" and banks is None:
            raise ValueError("knn serving needs reference banks "
                             "(knn.build_banks / knn.load_bank)")
        if knn_topk not in ("exact", "approx"):
            raise ValueError(f"unknown knn_topk {knn_topk!r} "
                             "(exact | approx)")
        if max_bucket < 1:
            raise ValueError(f"max_bucket must be >= 1, got {max_bucket}")
        if routing not in ("auto", "gather", "dense"):
            raise ValueError(f"unknown routing {routing!r} "
                             "(auto | gather | dense)")
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self._block: Optional[Tuple[int, int]] = None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.policy = get_policy(precision)
        self.model = model
        self.model_type = model_type
        self.multi_tenant = multi_tenant
        self.score_kind = score_kind
        self.knn_k = knn_k
        self.knn_topk = knn_topk
        placed = params_from_numpy(params, self.device,
                                   self.policy.compute_dtype)
        n = placed["encoder"]["Dense_0"]["kernel"].shape[0]
        if self.mesh is not None and multi_tenant \
                and n % self.mesh.world_size == 0:
            self._block = self.mesh.block(n)  # gateway-sharded
        self._state: Dict[str, Any] = {
            "params": self._place_params(placed),
            "centroids": self._place_centroids(centroids),
            "banks": self._place_banks(banks),
        }
        if not multi_tenant and n != 1:
            raise ValueError(f"a single-global engine serves one model; "
                             f"params stack {n}")
        self.num_gateways = n
        if banks is not None and banks.num_gateways != n:
            # a stale persisted bank must fail here: scoring would otherwise
            # route rows to another federation's banks
            raise ValueError(
                f"banks hold {banks.num_gateways} gateways but this "
                f"{'multi-tenant' if multi_tenant else 'single-tenant'} "
                f"engine serves {n}; was the bank persisted from a "
                "different federation?")
        if routing == "auto":
            routing = "dense" if n <= 32 else "gather"
        self.routing = routing
        self.max_bucket = 1 << (max_bucket - 1).bit_length()
        self._ladder = self._resolve_ladder(bucket_ladder)
        if roster is not None and roster.num_gateways != n:
            raise ValueError(
                f"roster describes {roster.num_gateways} gateway slots but "
                f"this engine serves {n}")
        self.roster = roster
        self.dim = int(model.input_dim)
        self.dispatches: collections.Counter = collections.Counter()
        self.swap_count = 0

    @property
    def gateway_sharded(self) -> bool:
        """Whether each rank holds its block of the gateways' state."""
        return self._block is not None

    @property
    def params(self):
        return self._state["params"]

    @property
    def centroids(self):
        return self._state["centroids"]

    @property
    def banks(self):
        return self._state["banks"]

    # --------------------------- placement ------------------------------- #

    def _place_params(self, params):
        """The resident compute copy: kernels in the policy's compute
        dtype, biases f32, stacked, on the engine's device (this rank's
        gateways only, when gateway-sharded)."""
        placed = params_from_numpy(params, self.device,
                                   self.policy.compute_dtype)
        if self._block is None:
            return placed
        lo, hi = self._block
        return {c: {d: {k: v[lo:hi] for k, v in layer.items()}
                    for d, layer in coder.items()}
                for c, coder in placed.items()}

    def _place_centroids(self, centroids):
        if centroids is None:
            return None
        cen = centroids.to(self.device)
        if self._block is None:
            return cen
        return cen.take(torch.arange(*self._block, device=self.device))

    def _place_banks(self, banks):
        if banks is None:
            return None
        banks = banks.to(self.device)
        if self._block is None:
            return banks
        lo, hi = self._block
        return ReferenceBank(latents=banks.latents[lo:hi].contiguous(),
                             count=banks.count[lo:hi])

    # ----------------------------- hot swap ------------------------------ #

    def _check_roster(self, gw: np.ndarray) -> None:
        """Rows routed to a retired slot fail here: the slot's resident
        model belongs to another tenant (or none)."""
        if self.roster is None or not len(gw):
            return
        bad = ~self.roster.member[gw]
        if bad.any():
            slots = sorted(set(int(g) for g in gw[bad]))
            shown = slots[:5]
            gens = {s: int(self.roster.generation[s]) for s in shown}
            raise UnknownGatewayError(
                f"UNKNOWN_GATEWAY: rows route to retired gateway slot(s) "
                f"{shown}{'...' if len(slots) > 5 else ''} (last tenant "
                f"generation {gens}); the tenant left the federation — "
                f"install the updated roster (swap_state(roster=...)) "
                f"alongside the recycled slot's params and calibration "
                f"if the slot was re-tenanted")

    def _merge_state(self, *, params=None, centroids=None, banks=None):
        """Validated, device-placed copy of the resident state with the
        given components replaced. Returns (new_state, swapped names)."""
        new = dict(self._state)
        swapped = []
        if params is not None:
            params = self._place_params(params)
            self._check_swap("params", self._state["params"], params)
            new["params"] = params
            swapped.append("params")
        if centroids is not None:
            if self._state["centroids"] is None:
                raise ValueError("engine was built without centroids; "
                                 "cannot swap them in (score_kind="
                                 f"{self.score_kind!r})")
            centroids = self._place_centroids(centroids)
            self._check_swap("centroids", self._state["centroids"], centroids)
            new["centroids"] = centroids
            swapped.append("centroids")
        if banks is not None:
            old = self._state["banks"]
            if old is None:
                raise ValueError("engine was built without kNN banks; "
                                 "cannot swap them in (score_kind="
                                 f"{self.score_kind!r})")
            if banks.num_gateways != self.num_gateways:
                raise ValueError(
                    f"swap banks hold {banks.num_gateways} gateways, "
                    f"engine serves {self.num_gateways}")
            if banks.latent_dim != old.latent_dim:
                raise ValueError(
                    f"swap banks latent_dim {banks.latent_dim} != "
                    f"resident {old.latent_dim}")
            new["banks"] = self._place_banks(banks)  # B may change
            swapped.append("banks")
        return new, swapped

    def swap_state(self, *, params=None, centroids=None, banks=None,
                   roster=None) -> Dict:
        """Install new params / centroids / kNN banks / roster for the
        NEXT dispatch; dispatched buckets keep the state they were launched
        with. Shapes, dtypes and tree structure must match the resident
        state (a swap comes from the same federation); a bank swap may
        change the capacity B, not L. Returns what was swapped."""
        new, swapped = self._merge_state(params=params, centroids=centroids,
                                         banks=banks)
        roster_delta = None
        if roster is not None:
            if roster.num_gateways != self.num_gateways:
                raise ValueError(
                    f"swap roster describes {roster.num_gateways} gateway "
                    f"slots, engine serves {self.num_gateways}")
            old = self.roster
            if old is not None:
                recycled = np.flatnonzero(roster.generation > old.generation)
                roster_delta = {
                    "joined": np.flatnonzero(roster.member
                                             & ~old.member).tolist(),
                    "left": np.flatnonzero(old.member
                                           & ~roster.member).tolist(),
                    "recycled": recycled.tolist()}
                if len(recycled) and params is None:
                    # the roster alone re-opens the slot without replacing
                    # the previous tenant's model it still serves
                    logger.warning(
                        "roster swap recycles slot(s) %s (generation "
                        "advanced) without a params swap in the same call; "
                        "those slots keep serving the previous tenant's "
                        "model until new params/banks/calibration arrive",
                        recycled.tolist()[:8])
            swapped.append("roster")
        if not swapped:
            raise ValueError("swap_state: nothing to swap")
        self._state = new  # one rebind; the next dispatch sees it whole
        if roster is not None:
            self.roster = roster
        self.swap_count += 1
        out = {"swapped": swapped, "swap_count": self.swap_count}
        if roster_delta is not None:
            out["roster_delta"] = roster_delta
        return out

    def candidate_state(self, *, params=None, centroids=None,
                        banks=None) -> Dict[str, Any]:
        """A validated state dict carrying the given replacements over the
        resident state WITHOUT installing it (score it with
        `score_candidate`)."""
        new, swapped = self._merge_state(params=params, centroids=centroids,
                                         banks=banks)
        if not swapped:
            raise ValueError("candidate_state: nothing replaced")
        return new

    def score_candidate(self, state: Dict[str, Any], x,
                        gateway_ids=None) -> np.ndarray:
        """`score` against a `candidate_state`; nothing is installed."""
        return self.score(x, gateway_ids, state=state)

    @staticmethod
    def _check_swap(name: str, old, new):
        lo, ln = _leaves(old), _leaves(new)
        if [k for k, _ in lo] != [k for k, _ in ln]:
            raise ValueError(f"swap {name}: structure mismatch "
                             f"({[k for k, _ in ln]} vs resident "
                             f"{[k for k, _ in lo]})")
        for (key, a), (_, b) in zip(lo, ln):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"swap {name}: {key} {tuple(b.shape)}/{b.dtype} does not "
                    f"match resident {tuple(a.shape)}/{a.dtype}; a hot swap "
                    "must come from the same federation architecture")

    # ----------------------------- buckets ------------------------------- #

    def _resolve_ladder(self, bucket_ladder) -> List[int]:
        """'pow2', an explicit ladder, or 'auto': the tuned ladder of this
        device, max_bucket and input width from the tuning cache
        (tune/sites.py lookup_serve_ladder), pow2 on a miss, an absent or
        a corrupt cache file."""
        if isinstance(bucket_ladder, str):
            if bucket_ladder not in ("auto", "pow2"):
                raise ValueError(f"unknown bucket_ladder {bucket_ladder!r} "
                                 "('auto' | 'pow2' | explicit sequence)")
            tuned = None
            if bucket_ladder == "auto":
                from fedmse_tpu_torch.tune import sites
                tuned = sites.lookup_serve_ladder(
                    self.max_bucket, int(self.model.input_dim),
                    device=self.device)
            if tuned is None:
                return [1 << i for i in range(self.max_bucket.bit_length())]
            bucket_ladder = tuned
        ladder = sorted({int(b) for b in bucket_ladder})
        if not ladder or ladder[0] < 1 or ladder[-1] != self.max_bucket:
            raise ValueError(
                f"bucket ladder {ladder} must be ascending positive rungs "
                f"ending at max_bucket {self.max_bucket}")
        return ladder

    @property
    def buckets(self) -> List[int]:
        return list(self._ladder)

    def bucket_for(self, n_rows: int) -> int:
        """Smallest ladder bucket holding n_rows (<= max_bucket)."""
        if n_rows > self.max_bucket:
            raise ValueError(f"{n_rows} rows exceed max_bucket "
                             f"{self.max_bucket}; chunk first")
        return self._ladder[bisect_left(self._ladder, max(n_rows, 1))]

    def warmup(self) -> Dict[int, float]:
        """Score one zero bucket at every rung (builds the kernel library on
        first use and warms the allocators); returns wall seconds per
        bucket."""
        out: Dict[int, float] = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            self._dispatch_chunk(np.zeros((b, self.dim), np.float32),
                                 np.zeros(b, np.int32)).harvest()
            out[b] = time.perf_counter() - t0
        return out

    # ----------------------------- scoring ------------------------------ #

    def _gateway_ids(self, gateway_ids, n: int) -> np.ndarray:
        if gateway_ids is None:
            if self.multi_tenant:
                raise ValueError(
                    "multi-tenant engine: pass gateway_ids so each row is "
                    "routed to its gateway's model")
            return np.zeros(n, np.int32)
        gw = np.asarray(gateway_ids, np.int32)
        if gw.shape != (n,):
            gw = np.broadcast_to(gw, (n,)).copy()
        if self.multi_tenant and n and (
                gw.min() < 0 or gw.max() >= self.num_gateways):
            raise ValueError(
                f"gateway ids must be in [0, {self.num_gateways}); "
                f"got range [{gw.min()}, {gw.max()}]")
        self._check_roster(gw)
        return gw

    def score(self, x, gateway_ids=None, *,
              state: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Anomaly scores [B] for rows `x` [B, D] (a single row [D] returns
        its scalar score). `gateway_ids` ([B] or a scalar) is required on
        the multi-tenant path and ignored on the single-global one.
        Requests pad up to the next bucket; oversize requests chunk at
        max_bucket."""
        x = np.asarray(x, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        n = x.shape[0]
        gw = self._gateway_ids(gateway_ids, n)
        out = np.empty(n, np.float32)
        for start in range(0, n, self.max_bucket):
            take = min(self.max_bucket, n - start)
            out[start:start + take] = self._dispatch_chunk(
                x[start:start + take], gw[start:start + take],
                state=state).harvest()
        return out[0] if squeeze else out

    def dispatch(self, x, gateway_ids=None) -> PendingScores:
        """Launch ONE bucket without waiting for its scores (the
        asynchronous half of `score`); rows must fit one bucket."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        if n > self.max_bucket:
            raise ValueError(f"dispatch takes at most one bucket "
                             f"({self.max_bucket} rows); got {n} — chunk "
                             "through score()")
        return self._dispatch_chunk(x, self._gateway_ids(gateway_ids, n))

    @torch.no_grad()
    def _dispatch_chunk(self, x: np.ndarray, gw: np.ndarray,
                        state: Optional[Dict[str, Any]] = None
                        ) -> PendingScores:
        """Pad one validated chunk to its bucket in pinned host memory,
        copy it to the card, launch, and start the copy back."""
        take, b = x.shape[0], self.bucket_for(x.shape[0])
        pin = self.device.type == "cuda"
        xh = torch.zeros((b, self.dim), dtype=self.policy.compute_dtype,
                         pin_memory=pin)
        xh[:take] = torch.from_numpy(x if x.flags.writeable else x.copy())
        gh = torch.zeros(b, dtype=torch.int32, pin_memory=pin)
        gh[:take] = torch.from_numpy(np.ascontiguousarray(gw))
        scores = self._score_rows(self._state if state is None else state,
                                  xh.to(self.device, non_blocking=True),
                                  gh.to(self.device, non_blocking=True))
        self.dispatches[b] += 1
        if not pin:
            return PendingScores(scores, take)
        host = torch.empty(b, dtype=torch.float32, pin_memory=True)
        host.copy_(scores, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return PendingScores(host, take, event)

    def _score_rows(self, state: Dict[str, Any], x: torch.Tensor,
                    gw: torch.Tensor) -> torch.Tensor:
        if self._block is None:
            return self._score_local(state, x, gw)
        # every rank scores the bucket against its block; each row takes
        # its owning rank's score (module docstring)
        lo, hi = self._block
        local = torch.clamp(gw.to(torch.int64) - lo, 0, hi - lo - 1)
        stack = self.mesh.all_gather(
            self._score_local(state, x, local.to(torch.int32)))
        owner = torch.div(gw.to(torch.int64), hi - lo, rounding_mode="floor")
        return stack.gather(0, owner[None])[0]

    def _score_local(self, state: Dict[str, Any], x: torch.Tensor,
                     gw: torch.Tensor) -> torch.Tensor:
        cdt = self.policy.compute_dtype
        latent, mse, _ = fused_forward_stats(
            state["params"], x, gw if self.multi_tenant else None,
            compute_dtype=cdt)
        if self.score_kind == "mse":
            scores = mse
        elif self.score_kind == "knn":
            banks = state["banks"]
            if self.multi_tenant:
                scores = routed_kth_distance(latent, gw, banks, self.knn_k,
                                             topk=self.knn_topk)
            else:
                scores = knn_kth_distance(latent, banks.latents[0],
                                          banks.count[0], self.knn_k,
                                          topk=self.knn_topk)
        else:
            cen = state["centroids"]
            scores = (cen.take(gw) if self.multi_tenant
                      else cen).get_density(latent)
        return torch.nan_to_num(scores)

    # --------------------------- constructors ---------------------------- #

    @classmethod
    def from_federation(cls, model, model_type: str, stacked_params,
                        train_x=None, train_m=None, *, score_kind="auto",
                        banks: Optional[ReferenceBank] = None,
                        knn_bank_size: int = 1024, knn_seed: int = 0,
                        device: DeviceLike = "cuda",
                        **kw) -> "ServingEngine":
        """Multi-tenant engine from in-memory stacked params. The centroid
        score fits its per-gateway centroids on the train rows (the
        FederatedData train_xb / train_mb); the kNN score builds its banks
        from the same rows (knn.build_banks, seed knn_seed) unless `banks`
        (a prebuilt or reloaded ReferenceBank) is given."""
        kind = resolve_score_kind(model_type, score_kind)
        dev = resolve_device(device)
        params = params_from_numpy(stacked_params, dev)
        centroids = None
        if kind == "centroid":
            if train_x is None:
                raise ValueError("centroid serving needs train rows to fit "
                                 "the per-gateway centroids")
            centroids = fit_gateway_centroids(model, params, train_x, train_m)
        if kind == "knn" and banks is None:
            if train_x is None:
                raise ValueError("knn serving needs train rows (or a "
                                 "prebuilt `banks`) to build the "
                                 "per-gateway reference banks")
            banks = build_banks(model, params, train_x, train_m,
                                bank_size=knn_bank_size, seed=knn_seed)
        return cls(model, model_type, params, centroids, banks=banks,
                   score_kind=score_kind, multi_tenant=True, device=dev, **kw)

    @classmethod
    def from_checkpoint(cls, writer, model, model_type: str,
                        update_type: str, device_names, run: int = 0,
                        train_x=None, train_m=None, *,
                        device: DeviceLike = "cuda",
                        **kw) -> "ServingEngine":
        """Multi-tenant engine from the ClientModel tree (`model.npz` per
        device, as either package's `save_client_models` writes it);
        `banks`, `knn_bank_size` and `knn_seed` pass to from_federation."""
        from fedmse_tpu_torch.checkpointing.io import load_client_models
        params = load_client_models(writer, run, model_type, update_type,
                                    device_names, device=device)
        return cls.from_federation(model, model_type, params,
                                   train_x=train_x, train_m=train_m,
                                   device=device, **kw)
