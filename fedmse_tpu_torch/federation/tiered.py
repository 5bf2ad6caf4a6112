"""Host-tiered federation rounds: the fleet's client state in host memory,
each round's cohort on the card (port of fedmse_tpu/federation/tiered.py,
`--state-layout tiered`).

The dense engine keeps every client's state on the device as [N, P]
tensors: params, Adam mu / nu, prev_global and hist_params, 135 KB a
client at the paper's width, so 100k gateways need 13.5 GB and 1M more
than the card holds. Here the whole fleet lives in pageable CPU tensors
(state.TieredClientStore) and a round moves only its cohort of C clients:

  * the round is the dense engine's FusedRound (rounds.build_fused_round),
    built once at width C on its own [C, ...] buffers with a chunk of one
    round, and on the card captured once into CUDA graphs. Each round the
    cohort's rows are COPIED into those buffers (`copy_`, outside any
    capture); a captured body reads only its own buffers, so rebinding
    them would replay the old addresses;
  * round k + 1's cohort is prefetched while round k runs: a worker
    thread gathers its state, data and kNN priority rows from the tier
    into one of two pinned staging slabs (`torch.index_select(out=)`),
    and copies the slab to the card's prefetch slab on a side stream,
    recording an event. At round k + 1's entry the compute stream waits
    on that event, the rows round k also held are patched on the card
    from the round buffers (which still hold round k's output:
    `index_select` / `index_copy_`, so exact), and the slab is copied
    into the round buffers. The first prefetch that overlaps a round is
    issued only once the round's graphs are captured;
  * round k's output state comes back into a pinned slab behind an event
    on the compute stream, and the host scatters it into the tier once
    the event has passed.

The round's selections are cohort positions (`CohortPlan.sel_pos`, in the
selection's order: first voter wins); `agg_count` is written every round
from the cohort's host counters; the tie-break draws are [S, S], drawn per
round from the run's generator at the selection's width and placed in the
selected clients' lanes (0.5, a factor of 1, in a pad lane), so at C == N
they are the dense engine's draws and a cohort padded to a multiple of
the ranks draws what the unpadded one does. That holds under the size
rule (voting.keyed_tie_break at (S, S)): while the selection's sheet,
S x S x 4 B (S the selected clients; the lanes that pad it to the ranks
do not count, so the rule does not move with W), stays within
voting.TIE_BREAK_SHEET_BYTES, the round takes those [S, C]
draws and the chaos re-election's [S, C] columns. Above it the tier holds
nothing of size S x C: the round is built with keyed tie-breaks
(fused.FusedRound `tie_keys`), each election computing on the device
only the row of the voter it reads from (run seed, "VOTE", the absolute
round, the voter's position in the selection, each lane's absolute
client id), the re-election from the chaos key and "RELE" alike
(utils/seeding.keyed_uniform_row); the run's generator draws no
tie-break. Keyed by absolute client, a padded or W-rank cohort draws
what W = 1 draws, and at C == N the tier keys when the dense engine does
(its rule at (S, N)) and computes the dense engine's rows. The chaos,
elastic and
cluster columns are gathered at the cohort's absolute ids (the fault
streams are keyed by absolute client, so a gathered column is the dense
engine's); pad lanes are inert.

Semantics against the dense layout, as in the JAX package: training,
vote, merge and verification are cohort-only in both; the dense round
broadcasts to and evaluates every client, the tiered round only its
cohort, so a non-cohort client's round metric is NaN. At
num_participants = 1.0 (C == N) the two layouts run the same round on the
same inputs and are equal bit for bit. Elastic joins and leaves apply to
the host rows at round entry (elastic.apply_membership_transitions, the
whole fleet's incumbent mean), so the round's own joined / left are zero
and the state gather waits for the round's entry. Clustering fits over
the tier in chunks of C.

Over a client mesh (`mesh=` a parallel.ClientMesh of W > 1 ranks) the
cohort pads to a multiple of W and each rank runs its block of C / W
lanes in `fused.ShardedFusedRound` (parallel/; every rank plans the same
cohort from the same host streams). Each rank gathers its lanes' rows at
round entry (no state prefetch: a lane's client may have been another
rank's lane last round), and after the round every rank scatters the
gathered cohort into its own whole tier, so the W tiers stay equal.
`host_sharded=True` keeps only rank j's block of the real clients
(parallel.mesh.process_tier_blocks) in its tier (state.TieredShardStore):
the selection is stratified by block from the one shared stream, the
cohort is W lane blocks (block j holds rank j's selected clients), each
rank gathers and scatters its own lanes only, the elastic incumbent mean
and the cluster fit's probe sum partials across ranks
(multihost.allgather_tree_sum), the fit's statistics and the final
evaluation are gathered block by block (multihost.allgather_blocks), and
a snapshot is one shard per rank (checkpointing/io.py `save_shard`). A
mesh whose ranks sit on more than one host (`ClientMesh.hosts`) is always
host-sharded, as the JAX tier is across processes: a plain tier would
keep the whole fleet on every host. `local_data=True` says `data` holds
only this rank's block of client rows (each host stacks its own), so host
memory stays flat as the fleet grows. A mesh of one rank with
host_sharded is the plain tier, bit for bit. The red team runs on the
dense engine; a null spec is accepted and builds nothing.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedmse_tpu_torch.chaos.masks import chaos_columns, reelection_columns
from fedmse_tpu_torch.cluster import assign as cluster_assign
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.federation import voting
from fedmse_tpu_torch.federation.attack import noise_draws
from fedmse_tpu_torch.federation.elastic import (MembershipMasks,
                                                 apply_membership_transitions,
                                                 make_membership_masks,
                                                 membership_at)
from fedmse_tpu_torch.federation.fused import FusedRound, FusedRoundOut
from fedmse_tpu_torch.federation.pipeline import (PrefetchedCohort,
                                                  TieredStats)
from fedmse_tpu_torch.federation.rounds import (MeshBackends, RoundResult,
                                                absorb_fused_out,
                                                build_fused_round,
                                                make_round_fns,
                                                split_metric_columns)
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               TieredClientStore,
                                               TieredShardStore,
                                               gather_rows)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import client_index, fused_forward_stats
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

logger = logging.getLogger(__name__)

# the per-client data a cohort gathers (dev_x is shared; client_mask is
# the plan's)
COHORT_DATA_FIELDS = ("train_xb", "train_mb", "valid_xb", "valid_mb",
                      "valid_x", "valid_m", "test_x", "test_m", "test_y")

def keyed_tie_break(cfg: ExperimentConfig, n_sel: int) -> bool:
    """Whether a tier selecting `n_sel` clients a round keys its
    tie-breaks: the size rule at (S, S), S x S x 4 B above
    voting.TIE_BREAK_SHEET_BYTES (64 MiB: S = 4,096, above every tier run
    that drew its sheet before the rule; the largest, chip_smoke's
    [tiered] (c), S = 512). False with the tie-break off."""
    return voting.keyed_tie_break(cfg, n_sel, n_sel)


@dataclasses.dataclass
class CohortPlan:
    """One round's cohort on the host. `ids` are the SORTED absolute
    client ids with a -1 pad tail to the cohort width (sorted, so a cohort
    of the whole fleet is the identity layout); `sel_pos` maps the
    selection's order onto cohort positions."""

    round_index: int
    selected: List[int]                # the host selection, in its order
    ids: np.ndarray                    # [C] int64, -1 pad tail
    sel_pos: np.ndarray                # [S] int64 cohort positions
    mask: np.ndarray                   # [C] f32: 1 = a real cohort row
    draws: Optional[torch.Tensor]      # [S, C] tie-break uniforms; None
                                       # (tie-break off, or keyed)
    rng_state: Optional[dict] = None   # the streams before this plan drew


@dataclasses.dataclass
class _Slab:
    """A cohort's state and data rows, [C, ...] each."""

    states: Optional[ClientStates]
    data: Dict[str, torch.Tensor]

    def tensors(self) -> List[torch.Tensor]:
        own = [] if self.states is None else self.states.tensors()
        return own + list(self.data.values())


class TieredRoundEngine(MeshBackends):
    """One (model_type, update_type) federation over the host tier (port of
    fedmse_tpu/federation/tiered.py `TieredRoundEngine`; module docstring).

    `run_round` is the serial round (the oracle), `run_rounds` the
    prefetched loop. `states` (a dense [N, ...] ClientStates, e.g. the JAX
    package's init) replaces the port's own init, as RoundEngine's does;
    `elastic_masks` replaces the spec's drawn membership timeline ([T, N]
    leaves). The round runs on `device` ("cuda" unless the caller asks for
    the CPU); the tier and the data stay on the host. `mesh`,
    `host_sharded` and `local_data` spread the round and the tier over
    ranks (module docstring); every rank must then drive its engine
    through the same calls."""

    def __init__(self, model, cfg: ExperimentConfig, data: FederatedData,
                 n_real: int, rngs: ExperimentRngs, model_type: str,
                 update_type: str, poison_fn=None, chaos=None, elastic=None,
                 mesh=None, init_chunk: Optional[int] = None, cluster=None,
                 host_sharded: bool = False, redteam=None, *,
                 local_data: bool = False,
                 states: Optional[ClientStates] = None,
                 elastic_masks: Optional[MembershipMasks] = None,
                 device: DeviceLike = "cuda"):
        if cfg.metric == "time":
            raise ValueError("metric='time' is host-side wall-clock and "
                             "cannot run inside the fused cohort round")
        if redteam is not None and not redteam.is_null:
            raise ValueError("redteam adversaries run on the dense fused "
                             "engine (state_layout='dense'); the tiered "
                             "layout accepts only a null RedteamSpec")
        if mesh is not None and not hasattr(mesh, "world_size"):
            raise ValueError(f"mesh must be a parallel.ClientMesh, got "
                             f"{type(mesh).__name__}")
        if mesh is not None and len(set(mesh.hosts)) > 1:
            host_sharded = True  # a plain tier cannot span hosts
        if host_sharded and mesh is None:
            raise ValueError("host_sharded tiers need a client mesh (the "
                             "shard layout is derived from it)")
        if elastic_masks is not None and elastic is None:
            raise ValueError("elastic_masks needs an ElasticSpec")
        if cfg.aggregation_backend not in ("einsum", "auto", "shard_map",
                                           "quantized"):
            raise ValueError(f"unknown aggregation_backend "
                             f"{cfg.aggregation_backend!r} (auto | einsum | "
                             "shard_map | quantized)")
        self.sharded = mesh is not None and mesh.sharded
        self.mesh = mesh if self.sharded else None
        self._merge_plan = None
        self.device = mesh.device if self.sharded else resolve_device(device)
        self.model, self.cfg, self.n_real, self.rngs = model, cfg, n_real, rngs
        self.model_type, self.update_type = model_type, update_type
        self.poison_fn, self.chaos, self.elastic = poison_fn, chaos, elastic
        self._warned_backend_off = False
        if init_chunk is None:
            # the measured chunk of this device (tune/sites.py), else 4096;
            # the tier's rows are the dense init's bits either way
            from fedmse_tpu_torch.tune import sites
            init_chunk = sites.lookup_tier_chunk(device=self.device) or 4096
        self.init_chunk = int(init_chunk)
        self.layout = ParamLayout.of(model)
        self.compact = cfg.compact_cohort is not False and not self.sharded
        self.fns = make_round_fns(model, cfg, model_type, update_type,
                                  cluster, self.device)
        self.evaluate_all = self.fns["evaluate_all"]

        # ---- the tier's layout over the ranks: one block per rank when
        # host-sharded, else the whole fleet on every rank
        world = mesh.world_size if mesh is not None else 1
        self.host_sharded = bool(host_sharded)
        if host_sharded:
            from fedmse_tpu_torch.parallel.mesh import process_tier_blocks
            self._blocks = process_tier_blocks(n_real, world)
            self._block_idx = mesh.rank
        else:
            self._blocks, self._block_idx = [(0, n_real)], 0
        self.shard_start, self.shard_stop = self._blocks[self._block_idx]
        self._fleet_local = (self.shard_start, self.shard_stop) == (0, n_real)
        lo, hi = self.shard_start, self.shard_stop

        # ---- the host tier: data and state rows by absolute client id
        # (a host-sharded tier keeps its block's rows only; local data
        # holds just those rows, from 0)
        if local_data and data.train_xb.shape[0] != hi - lo:
            raise ValueError(
                f"host-local data carries {data.train_xb.shape[0]} client "
                f"rows; this rank's block needs {hi - lo}")
        off = 0 if local_data else lo
        self.host_data = {name: getattr(data, name)[off:off + hi - lo].to(
            "cpu").contiguous() for name in COHORT_DATA_FIELDS}
        self._dev_x = data.dev_x.to(self.device)
        if self._fleet_local:
            self.store = (TieredClientStore.from_dense(
                states.apply(lambda t: t[:n_real])) if states is not None
                else TieredClientStore.create(model, n_real, rngs.generator,
                                              init_chunk=self.init_chunk))
        else:
            self.store = (TieredShardStore.from_dense_slice(
                states, n_real, lo, hi) if states is not None
                else TieredShardStore.create_shard(
                    model, n_real, rngs.generator, lo, hi,
                    init_chunk=self.init_chunk))
        self.host = HostState.create(n_real)
        # the fleet's rejected counters, from the gathered cohort outputs
        # (a host-sharded tier holds only its rows)
        self._rejected_full = (None if self._fleet_local
                               else np.zeros(n_real, np.int32))
        if len(self._blocks) > 1:
            # W lane blocks, block j rank j's own selected clients
            self._sel_counts = [max(1, int(cfg.num_participants * (b - a)))
                                for a, b in self._blocks]
            self._lane_width = max(self._sel_counts)
            self.n_sel = sum(self._sel_counts)
            self.cohort = self._lane_width * len(self._blocks)
        else:
            from fedmse_tpu_torch.parallel.mesh import pad_to_multiple
            self._sel_counts = None
            self.n_sel = max(1, int(cfg.num_participants * n_real))
            self.cohort = pad_to_multiple(self.n_sel, world) \
                if self.sharded else self.n_sel
            self._lane_width = self.cohort
        # this rank's lanes of the cohort
        self._lanes = (mesh.block(self.cohort) if self.sharded
                       else (0, self.cohort))
        # the size rule: above it no [S, C] tie-break sheet exists
        self.keyed_tie_break = keyed_tie_break(cfg, self.n_sel)

        # ---- the membership timeline (a Markov chain over the fleet) ----
        self._elastic_np = None
        if elastic is not None:
            self._elastic_np = elastic_masks if elastic_masks is not None \
                else make_membership_masks(elastic, rngs.elastic_key(),
                                           cfg.num_rounds, n_real)
        # transitions change host rows at round entry, and on a mesh a
        # lane's client may have been another rank's lane last round: the
        # state gather waits for the entry (the data prefetch does not)
        self._sync_gather = elastic is not None or self.sharded

        self.cluster = cluster
        self._cluster_vec: Optional[np.ndarray] = None
        self._cluster_fitted_round = 0
        self.cluster_fit = None
        self.stats = TieredStats()
        self._round: Optional[FusedRound] = None
        self._next_rng_state: Optional[dict] = None

    # ---- configuration ---- #

    @property
    def clustered(self) -> bool:
        return self.cluster is not None and not self.cluster.is_null

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    # ---- the round's buffers ---- #

    def _ensure_round(self) -> FusedRound:
        """The FusedRound at cohort width, its staging slabs, the card's
        prefetch slab and the side stream (built at the first round)."""
        if self._round is not None:
            return self._round
        dev, hd = self.device, self.host_data
        c = self._lanes[1] - self._lanes[0]  # this rank's lanes
        zeros = {name: torch.zeros((c,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device=dev) for name, t in hd.items()}
        data = FederatedData(**zeros, dev_x=self._dev_x,
                             client_mask=torch.zeros(c, device=dev))
        states = self.store.host.empty_rows(c, device=dev)
        for t in states.tensors():
            t.zero_()
        rows = hd["train_xb"].shape[1] * hd["train_xb"].shape[2]
        priorities = self.evaluate_all.bank_priorities(c, rows, dev)
        ver = self._constant_ver()
        ver_x, ver_m = ver if ver is not None else (data.valid_x,
                                                    data.valid_m)
        self._round = build_fused_round(
            self.model, self.cfg,
            self._mesh_fns() if self.sharded else self.fns, states=states,
            data=data, ver_x=ver_x, ver_m=ver_m, priorities=priorities,
            cohort=self.n_sel, capacity=1, compact=self.compact,
            poison_fn=self.poison_fn, chaos=self.chaos, elastic=self.elastic,
            cluster=self.cluster, mesh=self.mesh, n_global=self.cohort,
            tie_keys=({"vote": self.rngs.vote_key(),
                       "reelect": self.rngs.reelect_key()}
                      if self.keyed_tie_break else None))
        pin = self._cuda

        def slab(device, pinned):
            return _Slab(states=self.store.host.empty_rows(
                c, device=device, pin=pinned), data={
                    name: torch.empty(t.shape, dtype=t.dtype, device=device,
                                      pin_memory=pinned)
                    for name, t in self._round_data().items()})
        self._staging = [slab(torch.device("cpu"), pin) for _ in range(2)]
        self._flip = 0
        if self._cuda:
            self._dslab = slab(dev, False)  # the card's prefetch slab
            self._out = self.store.host.empty_rows(c, device="cpu", pin=True)
            self._side = torch.cuda.Stream(dev)
        self._consumed = None  # the compute stream took the prefetch slab
        return self._round

    def _round_data(self) -> Dict[str, torch.Tensor]:
        """The round's per-client data buffers by name: the cohort data,
        the client mask and the kNN bank priorities (a kNN score only)."""
        f = self._round
        out = {name: getattr(f.data, name) for name in COHORT_DATA_FIELDS}
        out["client_mask"] = f.data.client_mask
        if f.priorities is not None:
            out["priorities"] = f.priorities
        return out

    def _constant_ver(self):
        """The verification rows every cohort lane shares, on the device:
        the dev set (verification_method='dev') or the last real client's
        valid split (compat.shared_last_client_val); None when each client
        verifies on its own valid rows, which ride in the data slab."""
        cfg, dev = self.cfg, self.device
        if cfg.verification_method == "dev":
            return self._dev_x, torch.ones(self._dev_x.shape[0], device=dev)
        if cfg.compat.shared_last_client_val:
            last = self.n_real - 1
            if self._fleet_local:
                return (self.host_data["valid_x"][last].to(dev),
                        self.host_data["valid_m"][last].to(dev))
            # the last client's rows, from the rank that tiers it
            mine = self.shard_start <= last < self.shard_stop
            out = []
            for name in ("valid_x", "valid_m"):
                t = self.host_data[name]
                row = t[last - self.shard_start] if mine else \
                    torch.zeros(t.shape[1:], dtype=t.dtype)
                rows = self.mesh.gather_host(row.numpy())
                out.append(torch.from_numpy(rows[-1]).to(dev))
            return tuple(out)
        return None

    def _captured(self) -> bool:
        """Whether the round's bodies are captured (always, on the CPU):
        only then may a prefetch run beside a round."""
        f = self._round
        return not self._cuda or all(b.captured for b in
                                     (f.enter, f.epoch, f.leave))

    # ---- the plan ---- #

    def select_clients(self) -> List[int]:
        """The dense engine's draw: the same host stream, the same order.
        A host-sharded tier over W > 1 ranks stratifies it by block: each
        block's sample from the one shared stream, in block order, so
        every rank draws the same selection."""
        if self._sel_counts is None:
            return self.rngs.select_rng.sample(range(self.n_real),
                                               self.n_sel)
        out: List[int] = []
        for (lo, hi), n_sel in zip(self._blocks, self._sel_counts):
            out.extend(self.rngs.select_rng.sample(range(lo, hi), n_sel))
        return out

    def _plan(self, round_index: int,
              selected: Optional[List[int]] = None) -> CohortPlan:
        rng_state = self.rngs.state_dict()
        if selected is None:
            selected = self.select_clients()
        sel = np.asarray(selected, dtype=np.int64)
        ids = np.full(self.cohort, -1, dtype=np.int64)
        if self._sel_counts is None:
            srt = np.sort(sel)
            ids[:len(srt)] = srt
            sel_pos = np.searchsorted(srt, sel)
        else:  # lane block j: block j's sorted selected ids, a pad tail
            sel_pos = np.empty(len(sel), np.int64)
            w = self._lane_width
            for j, (lo, hi) in enumerate(self._blocks):
                in_blk = (sel >= lo) & (sel < hi)
                blk = sel[in_blk]
                if blk.size > w:
                    raise ValueError(f"block {j} selected {blk.size} "
                                     f"clients for {w} lanes")
                srt = np.sort(blk)
                ids[j * w:j * w + srt.size] = srt
                sel_pos[in_blk] = j * w + np.searchsorted(srt, blk)
        draws = None
        if self.cfg.compat.vote_tie_break and not self.keyed_tie_break:
            # the selected clients' columns from the run's generator, in
            # cohort order; 0.5 (a factor of 1) on the pad lanes
            draws = torch.full((len(sel), self.cohort), 0.5)
            draws[:, torch.from_numpy(ids >= 0)] = self.rngs.vote_draws(
                1, len(sel), len(sel))[0]
        return CohortPlan(round_index=round_index, selected=list(selected),
                          ids=ids, sel_pos=sel_pos,
                          mask=(ids >= 0).astype(np.float32), draws=draws,
                          rng_state=rng_state)

    def _lane_ids(self, plan: CohortPlan) -> np.ndarray:
        """The absolute ids of this rank's lanes (-1: a pad lane)."""
        lo, hi = self._lanes
        return plan.ids[lo:hi]

    def _local_rows(self, ids: np.ndarray) -> np.ndarray:
        """Absolute ids -> rows of this rank's host data (-1 outside its
        block, and pad lanes)."""
        if self._fleet_local:
            return ids
        local = np.asarray(ids) - self.shard_start
        local[(ids < self.shard_start) | (ids >= self.shard_stop)] = -1
        return local

    def rng_state_after_round(self) -> dict:
        """The streams' state after the last round consumed: a snapshot's
        resume point (the prefetched loop draws the next round's plan
        before the last round is consumed)."""
        return (self._next_rng_state if self._next_rng_state is not None
                else self.rngs.state_dict())

    # ---- prefetch, entry and dispatch ---- #

    def _gather_data(self, plan: CohortPlan,
                     out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The cohort's data rows into `out`, with its client mask and, for
        a kNN score, its gateways' bank priorities."""
        ids = self._lane_ids(plan)
        rows = self._local_rows(ids)
        for name in COHORT_DATA_FIELDS:
            gather_rows(self.host_data[name], rows, out=out[name])
        lo, hi = self._lanes
        out["client_mask"].copy_(torch.from_numpy(plan.mask[lo:hi]))
        if "priorities" in out:
            out["priorities"].copy_(self.evaluate_all.bank_priorities(
                len(ids), out["priorities"].shape[1], "cpu", ids=ids))
        return out

    def _prefetch(self, plan: CohortPlan) -> PrefetchedCohort:
        """Gather `plan`'s cohort into the next staging slab and, on the
        card, start its copy to the prefetch slab on the side stream. Runs
        in the prefetch worker beside a round, or inline."""
        t0 = time.time()
        stage = self._staging[self._flip]
        self._flip ^= 1
        states = (None if self._sync_gather
                  else self.store.gather(self._lane_ids(plan),
                                         out=stage.states))
        data = self._gather_data(plan, stage.data)
        ready = None
        if self._cuda:
            dst = self._dslab
            with torch.cuda.stream(self._side):
                if self._consumed is not None:
                    self._side.wait_event(self._consumed)
                pairs = zip(dst.data.values(), data.values())
                if states is not None:
                    pairs = list(pairs) + list(zip(dst.states.tensors(),
                                                   states.tensors()))
                for d, s in pairs:
                    d.copy_(s, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._side)
            states = None if states is None else dst.states
            data = dst.data
        pf = PrefetchedCohort(plan=plan, slab=states, data=data, ready=ready,
                              t_issue_start=t0, t_issue_end=time.time())
        pf.stage = stage
        return pf

    def _wait(self, pf: PrefetchedCohort) -> None:
        """The host waits for the prefetch's copy to land (the prefetch
        gap) and the compute stream orders after it."""
        if pf.ready is not None:
            pf.ready.synchronize()
            torch.cuda.current_stream(self.device).wait_event(pf.ready)

    def _patch(self, slab: ClientStates, prev: CohortPlan,
               plan: CohortPlan) -> None:
        """Rows of `plan`'s cohort that `prev`'s cohort held are stale in
        the prefetched slab: take them from the round buffers, which hold
        `prev`'s output (exact: index_select / index_copy_)."""
        s = len(prev.selected)
        base = prev.ids[:s]
        src = np.searchsorted(base, plan.ids).clip(0, s - 1)
        take = (base[src] == plan.ids) & (plan.ids >= 0)
        if not take.any():
            return
        dev = self.device
        dst_pos = torch.from_numpy(np.flatnonzero(take)).to(dev)
        src_pos = torch.from_numpy(src[take]).to(dev)
        for d, r in zip(slab.tensors(), self._round.states.tensors()):
            d.index_copy_(0, dst_pos, r.index_select(0, src_pos))

    def _load(self, pf: PrefetchedCohort,
              prev: Optional[CohortPlan]) -> None:
        """Round entry: the cohort's rows into the round's buffers. The
        prefetched state is patched from `prev`'s output first; without a
        prefetched state (elastic) the rows are gathered now, after the
        round's transitions."""
        f = self._round
        if pf.slab is None:
            rows = self.store.gather(self._lane_ids(pf.plan),
                                     out=pf.stage.states)
            for d, s in zip(f.states.tensors(), rows.tensors()):
                d.copy_(s, non_blocking=self._cuda)
        else:
            if prev is not None:
                self._patch(pf.slab, prev, pf.plan)
            f.states.copy_(pf.slab)
        for name, buf in self._round_data().items():
            buf.copy_(pf.data[name])
        if self._cuda:
            self._consumed = torch.cuda.Event()
            self._consumed.record(torch.cuda.current_stream(self.device))

    def _mask_kwargs(self, plan: CohortPlan) -> dict:
        """FusedRound.dispatch's hook inputs ([1, ...] each) and cluster
        column for the round: the attack's bit and noise, and the chaos,
        membership and cluster columns gathered at the cohort's ABSOLUTE
        ids, pad lanes inert. The entry transitions were applied to the
        host rows, so the round's joined / left are zero."""
        t = plan.round_index
        rows = np.maximum(plan.ids, 0)
        pad = plan.ids < 0
        inputs: Dict[str, np.ndarray] = {}
        if self.poison_fn is not None:
            inputs["attack"] = self.poison_fn.active(t, 1)
            if self.poison_fn.needs_noise:
                width = self.layout.size * (self.cluster.k if self.clustered
                                            else 1)
                inputs["noise"] = noise_draws(self.rngs.attack_key(), t, 1,
                                              width)
        if self.chaos is not None:
            m = self._chaos_columns(t, rows)
            inputs.update(available=np.where(pad, 1.0, m.available),
                          straggler=np.where(pad, 0.0, m.straggler),
                          crash=m.crash,
                          bcast_drop=np.where(pad, 0.0, m.bcast_drop))
            if self.cfg.compat.vote_tie_break and not self.keyed_tie_break:
                inputs["reelect_draws"] = self._reelect_columns(
                    t, rows, self.n_sel)[None]
        if self._elastic_np is not None:
            e = self._elastic_np
            zeros = np.zeros((1, self.cohort), np.float32)
            inputs.update(
                member=np.where(pad, 0.0, e.member[t][rows])[None],
                joined=zeros, left=zeros,
                generation=np.where(pad, 0, e.generation[t][rows])[None])
        cluster_in = None
        if self.clustered:
            cluster_in = np.where(pad, 0, self._cluster_vec[rows])
        return {"inputs": inputs, "cluster_in": cluster_in}

    def _chaos_columns(self, round_index: int, rows: np.ndarray):
        """Round `round_index`'s chaos masks at the cohort's clients."""
        return chaos_columns(self.chaos, self.rngs.chaos_key(), round_index,
                             rows)

    def _reelect_columns(self, round_index: int, rows: np.ndarray,
                         voters: int) -> np.ndarray:
        """[S, C] crash re-election draws at the cohort's clients."""
        return reelection_columns(self.rngs.chaos_key(), round_index,
                                  voters, rows)

    def _dispatch(self, pf: PrefetchedCohort) -> Callable[[], list]:
        plan = pf.plan
        agg = np.zeros(self.cohort, np.int32)
        real = plan.ids >= 0
        agg[real] = self.host.aggregation_count[plan.ids[real]]
        keyed = {}
        if self.keyed_tie_break:
            keyed = {"rounds": [plan.round_index], "lane_ids": plan.ids}
        return self._round.dispatch(
            [plan.sel_pos.tolist()],
            None if plan.draws is None else plan.draws[None], agg,
            **self._mask_kwargs(plan), start_round=plan.round_index,
            **keyed)

    def _fetch_states(self) -> ClientStates:
        """The round's output state on its way to the host: into the
        pinned out slab behind an event on the card (the round buffers
        themselves on the CPU)."""
        if self.sharded:
            from fedmse_tpu_torch.parallel.mesh import host_fetch
            st = self._round.states
            if self.host_sharded:  # this rank's own lanes
                return st.apply(lambda t: t.detach().to("cpu", copy=True))
            # the whole cohort, gathered: every rank's tier takes it
            return st.apply(lambda t: torch.from_numpy(
                host_fetch(t, self.mesh)))
        if not self._cuda:
            return self._round.states
        for d, s in zip(self._out.tensors(), self._round.states.tensors()):
            d.copy_(s, non_blocking=True)
        self._out_ready = torch.cuda.Event()
        self._out_ready.record(torch.cuda.current_stream(self.device))
        return self._out

    def _scatter_out(self, plan: CohortPlan, slab: ClientStates) -> None:
        if self.sharded:
            self.store.scatter(self._lane_ids(plan) if self.host_sharded
                               else plan.ids, slab)
            return
        if self._cuda:
            self._out_ready.synchronize()
        self.store.scatter(plan.ids, slab)

    def _entry_transitions(self, round_index: int) -> None:
        if self._elastic_np is None:
            return
        e = self._elastic_np
        merge = None
        if not self._fleet_local:
            from fedmse_tpu_torch.parallel.multihost import \
                allgather_tree_sum
            merge = lambda parts: allgather_tree_sum(  # noqa: E731
                parts, self.mesh)
        apply_membership_transitions(
            self.store, e.member[round_index][:self.n_real],
            e.joined[round_index][:self.n_real],
            e.left[round_index][:self.n_real],
            assignment=self._cluster_vec,
            k=1 if self.cluster is None else self.cluster.k,
            merge_partials=merge)

    def _absorb(self, out: FusedRoundOut, plan: CohortPlan) -> RoundResult:
        """The cohort's outputs at fleet width, then the dense engine's
        bookkeeping (rounds.absorb_fused_out) with the verification rows
        of the cohort only."""
        n, ids = self.n_real, plan.ids
        real = ids >= 0
        rows = ids[real]

        def scatter(vals, fill):
            vals = np.asarray(vals)
            full = np.full((n,) + vals.shape[1:], fill, np.float32)
            full[rows] = vals[real]
            return full

        def absolute(pos):
            return None if pos is None else (int(ids[pos]) if pos >= 0
                                              else -1)
        if self._fleet_local:
            rejected = self.store.host.rejected.numpy()
        else:  # the fleet's mirror, from the gathered cohort outputs
            self._rejected_full[rows] = np.asarray(
                out.rejected)[real].astype(np.int32)
            rejected = self._rejected_full
        member = generation = None
        if self._elastic_np is not None:
            member = self._elastic_np.member[plan.round_index][:n]
            generation = self._elastic_np.generation[
                plan.round_index][:n].astype(np.int64)
        full = FusedRoundOut(
            aggregator=absolute(out.aggregator),
            metrics=scatter(out.metrics, np.nan),
            scores=scatter(out.scores, np.nan),
            weights=scatter(out.weights, 0.0),
            rejected=rejected,
            min_valid=scatter(out.min_valid, np.nan),
            tracking=scatter(out.tracking, np.nan),
            eff_mask=(None if out.eff_mask is None
                      else scatter(out.eff_mask, 0.0)),
            crashed=absolute(out.crashed),
            divergence=(None if out.divergence is None
                        else scatter(out.divergence, 0.0)),
            member=member, generation=generation)
        return absorb_fused_out(full, plan.round_index, plan.selected, n,
                                self.host, self.cfg.max_rejected_updates,
                                row_ids=rows)

    # ---- the loops ---- #

    def run_round(self, round_index: int,
                  selected: Optional[List[int]] = None) -> RoundResult:
        """One round with no prefetch overlap: the serial oracle the
        prefetched loop is held to."""
        self._ensure_round()
        self._ensure_cluster(round_index)
        plan = self._plan(round_index, selected)
        self._entry_transitions(round_index)
        pf = self._prefetch(plan)
        self._wait(pf)
        self._load(pf, None)
        harvest = self._dispatch(pf)
        states = self._fetch_states()
        out = harvest()[0]
        self._scatter_out(plan, states)
        self.stats.rounds += 1
        return self._absorb(out, plan)

    def run_rounds(self, start_round: int, num_rounds: int,
                   consume: Callable[[RoundResult, float], bool]
                   ) -> TieredStats:
        """The prefetched loop: round k + 1's cohort is gathered and copied
        to the card while round k runs, its rows patched from round k's
        output at its entry. `consume(result, sec)` absorbs a round and
        returns True to stop; the speculative prefetch is then dropped
        (its draws advanced the host streams one round, which
        `rng_state_after_round` accounts for)."""
        self._ensure_round()
        stats = self.stats
        end = start_round + num_rounds
        if num_rounds <= 0:
            return stats
        self._ensure_cluster(start_round)
        self._entry_transitions(start_round)
        pending = self._prefetch(self._plan(start_round))
        prev: Optional[CohortPlan] = None
        t_harvest_prev = None
        k = start_round
        with concurrent.futures.ThreadPoolExecutor(1) as worker:
            while k < end:
                t0 = time.time()
                if isinstance(pending, concurrent.futures.Future):
                    pf = pending.result()
                    stats.prefetch_issue_s.append(pf.t_issue_end
                                                  - pf.t_issue_start)
                    stats.overlapped_issue.append(
                        pf.t_issue_end <= t_harvest_prev)
                else:
                    pf = pending
                self._wait(pf)
                stats.prefetch_wait_s.append(time.time() - t0)
                plan = pf.plan
                self._load(pf, prev)
                nxt = self._plan(k + 1) if k + 1 < end else None
                pending = None
                early = nxt is not None and self._captured()
                if early:
                    pending = worker.submit(self._prefetch, nxt)
                harvest = self._dispatch(pf)
                states = self._fetch_states()
                if nxt is not None and not early:
                    # the graphs were captured just now, with no copy
                    # beside them; from the next round on they overlap
                    pending = worker.submit(self._prefetch, nxt)
                out = harvest()[0]
                t_harvest_prev = time.time()
                self._scatter_out(plan, states)
                result = self._absorb(out, plan)
                stats.rounds += 1
                self._next_rng_state = None if nxt is None else nxt.rng_state
                stop = consume(result, time.time() - t0)
                if stop or nxt is None:
                    if pending is not None:
                        pending.result()  # the worker's staging is settled
                    break
                # the next round's refit and transitions read this round's
                # results, in the serial round's order
                self._ensure_cluster(k + 1)
                self._entry_transitions(k + 1)
                prev = plan
                k += 1
        self._next_rng_state = None
        return stats

    # ---- clustering ---- #

    @property
    def cluster_assignment(self) -> Optional[np.ndarray]:
        return self._cluster_vec

    @property
    def cluster_fitted_round(self) -> int:
        return int(self._cluster_fitted_round)

    def set_cluster_assignment(self, assignment, fitted_round: int = 0
                               ) -> None:
        """Pin the assignment (a resume's recorded one)."""
        assignment = np.asarray(assignment, np.int32)
        if len(assignment) != self.n_real:
            raise ValueError(f"assignment covers {len(assignment)} "
                             f"gateways, federation has {self.n_real}")
        self._cluster_vec = assignment
        self._cluster_fitted_round = fitted_round

    def _ensure_cluster(self, round_index: int) -> None:
        """Fit (or refit on the cadence) the assignment: the dense
        engine's due rule."""
        if not self.clustered:
            return
        due = (self._cluster_vec is None
               or (self.cluster.refit_every > 0
                   and round_index - self._cluster_fitted_round
                   >= self.cluster.refit_every))
        if not due:
            return
        self._cluster_vec = self._fit_cluster(round_index).assignment
        self._cluster_fitted_round = round_index

    def _fit_cluster(self, round_index: int = 0):
        """Latent statistics over the tier in chunks of C on the device,
        under the fleet's mean model (the tier's current params), then the
        JS k-medoids (cluster.fit_assignments), as the JAX tier fits."""
        dev, c, n = self.device, self.cohort, self.n_real
        stats_fn = cluster_assign.make_latent_stats_fn(self.model)
        params = self.store.host.params
        if self._fleet_local:
            probe = cluster_assign.incumbent_mean_params(
                params, torch.ones(n)).to(dev)
        else:  # the fleet's mean from the ranks' partial sums
            from fedmse_tpu_torch.parallel.multihost import \
                allgather_tree_sum
            total = allgather_tree_sum(
                [params.to(torch.float32).sum(dim=0).numpy()], self.mesh)[0]
            probe = torch.from_numpy((total / n).astype(np.float32)).to(dev)
            c, n = self._lane_width, self.shard_stop - self.shard_start
        means, covs = [], []
        for start in range(0, n, c):
            stop = min(start + c, n)
            m, v = stats_fn(probe,
                            self.host_data["train_xb"][start:stop].to(dev),
                            self.host_data["train_mb"][start:stop].to(dev))
            means.append(m.cpu().numpy())
            covs.append(v.cpu().numpy())
        means, covs = np.concatenate(means), np.concatenate(covs)
        if not self._fleet_local:  # every rank fits the same fleet
            from fedmse_tpu_torch.parallel.multihost import allgather_blocks
            order = list(range(len(self._blocks)))
            means = allgather_blocks(means, self._blocks, order, self.mesh)
            covs = allgather_blocks(covs, self._blocks, order, self.mesh)
        fit = cluster_assign.fit_assignments(
            means, covs, self.cluster.k,
            fitted_round=round_index, sample=self.cluster.fit_sample,
            device=dev)
        self.cluster_fit = fit
        logger.info("tiered cluster fit at round %d: k=%d sizes=%s",
                    round_index, self.cluster.k,
                    np.bincount(fit.assignment,
                                minlength=self.cluster.k).tolist())
        return fit

    # ---- evaluation, accounting, checkpoints ---- #

    def _chunks(self):
        """(start, stop) cohort-wide chunks of this rank's tier rows (the
        fleet's, unless host-sharded)."""
        c = self.cohort if self._fleet_local else self._lane_width
        n = self.shard_stop - self.shard_start
        return [(s, min(s + c, n)) for s in range(0, n, c)]

    @torch.no_grad()
    def evaluate_final_streamed(self) -> np.ndarray:
        """Every client's evaluation in chunks of C on the device, never a
        fleet-wide device tensor: the dense engine's `evaluate`. A
        host-sharded rank evaluates its rows, and the blocks are gathered
        (the same array on every rank)."""
        dev, hd = self.device, self.host_data
        outs = []
        for start, stop in self._chunks():
            rows = slice(start, stop)
            first = self.shard_start + start
            pri = self.evaluate_all.bank_priorities(
                stop - start,
                hd["train_xb"].shape[1] * hd["train_xb"].shape[2], dev,
                ids=range(first, first + stop - start))
            out = self.evaluate_all(
                self.layout.tree(self.store.host.params[rows].to(dev)),
                hd["test_x"][rows].to(dev), hd["test_m"][rows].to(dev),
                hd["test_y"][rows].to(dev), hd["train_xb"][rows].to(dev),
                hd["train_mb"][rows].to(dev), priorities=pri)
            outs.append(out.cpu().numpy())
        local = np.concatenate(outs, axis=0)
        if self._fleet_local:
            return local
        from fedmse_tpu_torch.parallel.multihost import allgather_blocks
        return allgather_blocks(local, self._blocks,
                                list(range(len(self._blocks))), self.mesh)

    def cohort_bytes(self) -> Dict[str, int]:
        """The device bytes of the steady loop, by slab. The state slab
        lives three times (the round's buffers, the trainer's cohort
        buffers of the same five [C, P] rows, the prefetch slab) and the
        data and verification slabs twice (the round's and the prefetch
        slab); C appears everywhere, N nowhere."""
        c = self.cohort
        state = self.store.slab_bytes(c)
        per_client = sum(t[0].numel() * t.element_size()
                         for t in self.host_data.values())
        data = (c * per_client + self._dev_x.numel()
                * self._dev_x.element_size() + 4 * c)
        ver = self._constant_ver()
        ver_bytes = 0 if ver is None else sum(
            t.numel() * t.element_size() for t in ver)
        return {"cohort": c, "state_slab_bytes": state,
                "data_slab_bytes": data, "ver_slab_bytes": ver_bytes,
                "device_total_bytes": 3 * state + 2 * (data + ver_bytes)}

    def members_at(self, round_index: int) -> Optional[np.ndarray]:
        """[n_real] bool occupancy after `round_index` rounds (None without
        an ElasticSpec)."""
        if self._elastic_np is None:
            return None
        return membership_at(self._elastic_np, round_index, self.n_real)[0]

    def generation_at(self, round_index: int) -> Optional[np.ndarray]:
        if self._elastic_np is None:
            return None
        return membership_at(self._elastic_np, round_index, self.n_real)[1]

    def states_for_checkpoint(self, n_pad: int) -> ClientStates:
        """The tier's states padded with zero rows to the dense snapshot
        width: dense and tiered snapshots interchange."""
        if n_pad == self.n_real:
            return self.store.host
        return self.store.host.apply(lambda t: torch.cat([t, torch.zeros(
            (n_pad - self.n_real,) + tuple(t.shape[1:]), dtype=t.dtype)]))

    def restore_states(self, states: ClientStates) -> None:
        """Adopt a restored snapshot into the tier: a dense-width one, or
        this rank's rows of a host-sharded one."""
        if self._fleet_local:
            self.store = TieredClientStore.from_dense(
                states.apply(lambda t: t[:self.n_real]))
        else:
            self.store = TieredShardStore(
                states.apply(lambda t: t.detach().to(
                    "cpu", copy=True).contiguous()), self.n_real,
                self.shard_start, self.shard_stop)


@torch.no_grad()
def _save_hybrid_latents_streamed(writer, engine: TieredRoundEngine,
                                  run: int, update_type: str,
                                  params: Optional[torch.Tensor] = None,
                                  data=None) -> None:
    """The hybrid's test latents and labels of every client, computed in
    chunks of C (main._save_hybrid_latents without a fleet-wide device
    tensor). A host-sharded tier passes the fleet's gathered `params` and
    its whole `data`."""
    from fedmse_tpu_torch.checkpointing import save_latent_data
    dev, hd = engine.device, engine.host_data
    chunks = engine._chunks()
    if params is None:
        params = engine.store.host.params
    else:
        hd = {name: getattr(data, name) for name in ("test_x", "test_m",
                                                     "test_y")}
        c, n = engine.cohort, engine.n_real
        chunks = [(s, min(s + c, n)) for s in range(0, n, c)]
    cdt = engine.model.compute_dtype
    lat_parts, lab_parts = [], []
    for start, stop in chunks:
        n, t = stop - start, hd["test_x"].shape[1]
        latent, _, _ = fused_forward_stats(
            engine.layout.tree(params[start:stop].to(dev), cdt),
            hd["test_x"][start:stop].to(dev).reshape(n * t, -1).to(cdt),
            client_index(n, t, dev), compute_dtype=cdt)
        mask = hd["test_m"][start:stop].reshape(-1).numpy() > 0
        lat_parts.append(latent.cpu().numpy()[mask])
        lab_parts.append(hd["test_y"][start:stop].reshape(-1).numpy()[mask])
    save_latent_data(writer, run, update_type, np.concatenate(lat_parts),
                     np.concatenate(lab_parts))


def run_tiered_combination(cfg: ExperimentConfig, data, n_real: int,
                           model_type: str, update_type: str, run: int,
                           writer=None, early_stop=None,
                           device_names: Optional[List[str]] = None,
                           mesh=None, resume=None,
                           save_checkpoints: bool = False, attack=None,
                           chaos=None, elastic=None, cluster=None, *,
                           states: Optional[ClientStates] = None,
                           on_round=None, local_data: bool = False,
                           device: DeviceLike = "cuda") -> Dict:
    """main.run_combination for state_layout='tiered' (port of
    fedmse_tpu/federation/tiered.py `run_tiered_combination`): the same
    artifacts, bookkeeping, early stop and resume, with the prefetched
    cohort loop in place of the dense schedule. Returns run_combination's
    dict plus the loop's telemetry under 'tiered_stats'. `local_data=True`
    marks `data` as this rank's block of client rows only (the engine's
    `local_data`)."""
    from fedmse_tpu_torch.checkpointing import (save_client_models,
                                                save_training_tracking)
    from fedmse_tpu_torch.federation.attack import make_poison_fn
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.parallel.mesh import ClientMesh
    from fedmse_tpu_torch.parallel.multihost import (allgather_blocks,
                                                     uniform_decision)
    dev = resolve_device(device)
    if cfg.host_sharded and mesh is None:
        mesh = ClientMesh(device=dev)  # one rank: the plain tier's bits
    rngs = ExperimentRngs(run=run, data_seed=cfg.data_seed,
                          run_seed_stride=cfg.run_seed_stride)
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=dev)
    engine = TieredRoundEngine(
        model, cfg, data, n_real=n_real, rngs=rngs, model_type=model_type,
        update_type=update_type,
        poison_fn=None if attack is None else make_poison_fn(attack),
        chaos=chaos, elastic=elastic, mesh=mesh, cluster=cluster,
        host_sharded=cfg.host_sharded, local_data=local_data,
        states=states, device=dev)
    pod = not engine._fleet_local  # one snapshot shard per rank
    n_pad = data.client_mask.shape[0]
    round_times: List[float] = []
    all_tracking: List[np.ndarray] = []
    results: List[RoundResult] = []
    tag = f"{model_type}_{update_type}_run{run}"
    start_round = 0
    elastic_sig = None if elastic is None else elastic.signature()
    cluster_sig = None if cluster is None else cluster.signature()
    expected = {"flatten_optimizer": False, "elastic": elastic_sig,
                "cluster": cluster_sig}
    defaults = {"flatten_optimizer": False, "elastic": None,
                "cluster": None}

    def snapshot(rounds_done: int) -> None:
        gen = engine.generation_at(rounds_done)
        extra = {**expected,
                 "elastic_generation": None if gen is None else gen.tolist(),
                 "rngs": engine.rng_state_after_round()}
        if engine.cluster_assignment is not None:
            extra.update(cluster_k=cluster.k,
                         cluster_assignment=engine.cluster_assignment.tolist(),
                         cluster_fitted_round=engine.cluster_fitted_round)
        tracking = (np.concatenate(all_tracking, axis=1) if all_tracking
                    else None)
        if pod:
            resume.save_shard(tag, engine.store.host, engine.host,
                              rounds_done, engine.shard_start,
                              engine.shard_stop, engine._blocks,
                              layout=engine.layout, extra=extra,
                              tracking=tracking, mesh=engine.mesh)
            return
        # every rank of a mesh holds the same tier: rank 0 writes it
        if engine.mesh is None or engine.mesh.rank == 0:
            resume.save(tag, engine.states_for_checkpoint(n_pad),
                        engine.host, rounds_done, layout=engine.layout,
                        extra=extra, tracking=tracking)
        if engine.mesh is not None:
            engine.mesh.barrier()

    if resume is not None and resume.exists(tag):
        if engine.clustered:
            from fedmse_tpu_torch.cluster import assignment_from_extra
            saved = resume.extra(tag)
            vec = assignment_from_extra(saved, cluster, n_real)
            if vec is not None:
                engine.set_cluster_assignment(
                    vec, saved.get("cluster_fitted_round", 0))
        restored, engine.host, start_round, tracking = resume.restore(
            tag, layout=engine.layout, device="cpu",
            expected_extra=expected, extra_defaults=defaults,
            rows=(engine.shard_start, engine.shard_stop) if pod else None)
        engine.restore_states(restored)
        saved_rngs = resume.extra(tag).get("rngs")
        if saved_rngs is not None:
            engine.rngs.load_state_dict(saved_rngs)
        if tracking is not None:
            all_tracking.append(tracking)
        logger.info("resumed %s (tiered) at round %d", tag, start_round)

    def bookkeep(result: RoundResult, sec: float) -> bool:
        round_times.append(sec)
        all_tracking.append(result.tracking)
        results.append(result)
        if on_round is not None:
            on_round(result, sec)
        logger.info("[%s/%s run %d] round %d: agg=%s mean %s=%.4f (%.2fs)",
                    model_type, update_type, run, result.round_index + 1,
                    result.aggregator, cfg.metric,
                    float(np.nanmean(result.client_metrics)), sec)
        if writer is not None:
            writer.append_round_metrics(run, result.round_index,
                                        result.client_metrics, model_type,
                                        update_type)
            writer.append_verification(run, result.round_index,
                                       result.verification_results)
        if resume is not None:
            snapshot(result.round_index + 1)
        stop = early_stop is not None and early_stop.should_stop(
            result.client_metrics)
        if engine.mesh is not None:  # rank 0's decision
            stop = uniform_decision(stop, engine.mesh)
        if stop:
            logger.info("Early stopping in global round!")
        return stop

    stats = engine.run_rounds(start_round, cfg.num_rounds - start_round,
                              bookkeep)
    final_metrics, final_full = split_metric_columns(
        engine.evaluate_final_streamed())
    if elastic is not None:
        member = engine.members_at(results[-1].round_index + 1 if results
                                   else start_round)
        final_metrics = np.where(member, final_metrics, np.nan)
        if final_full is not None:
            final_full = np.where(member[:, None], final_full, np.nan)
    params = full = None
    if pod and local_data and save_checkpoints and device_names:
        # no rank holds the fleet's test rows, as in the JAX pod: the
        # sharded snapshot is the durable artifact
        logger.warning("host-local data: skipping the per-client model "
                       "export (restore the sharded snapshot in one "
                       "process to write ClientModel/)")
        save_checkpoints = False
    if pod and save_checkpoints and device_names:
        # the fleet's params from the ranks' blocks (a collective)
        params = torch.from_numpy(allgather_blocks(
            engine.store.host.params.numpy(), engine._blocks,
            list(range(len(engine._blocks))), engine.mesh))
        full = data
    if writer is not None and save_checkpoints and device_names:
        save_client_models(writer, run, model_type, update_type,
                           device_names,
                           engine.layout.tree(engine.store.host.params
                                              if params is None else params))
        if all_tracking:
            save_training_tracking(writer, run, model_type, update_type,
                                   device_names,
                                   np.concatenate(all_tracking, axis=1))
        if model_type == "hybrid":
            _save_hybrid_latents_streamed(writer, engine, run, update_type,
                                          params=params, data=full)
    out = {
        "final_metrics": final_metrics,
        "best_final": float(np.nanmax(final_metrics)),
        "round_times": round_times,
        "rounds_run": len(round_times),
        "aggregation_count": engine.host.aggregation_count.tolist(),
        "votes_received": engine.host.votes_received.tolist(),
        "aggregation_backend_effective": engine.agg_backend,
        "rounds": results,
        "engine": engine,
        "pipeline": None,
        "tiered_stats": stats.summary(),
    }
    if final_full is not None:
        out["final_metrics_full"] = final_full
    return out
