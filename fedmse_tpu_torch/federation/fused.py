"""The fused round: a round, and a chunk of rounds, with no host work
inside (port of fedmse_tpu/federation/fused.py).

The JAX package compiles the round into one XLA program, moving the
election's data-dependent control flow into `lax.while_loop` / `lax.cond`,
and scans it over a chunk of rounds. Here the round is three bodies that
read and write static device buffers in place, each a `CapturedBody`
(ops/graphs.py): captured once into a CUDA graph per engine on the card
and replayed; called eagerly on the CPU (the same code, op for op):

  * `enter`: round r's selection (slot r of the chunk's [R, S] upload) and
    its tie-break draws into static buffers; the cohort's params, Adam
    state, anchors and data gathered (LocalTrainer.begin);
  * `epoch`: one epoch of local training (LocalTrainer.epoch). The host
    replays it once per epoch and reads the device's "some client still
    active" flag of epoch e only after epoch e + 1 is enqueued: an epoch
    after every client stopped changes nothing, so the speculative epoch
    is exact and the host stays an epoch ahead of the card;
  * `leave`: the cohort scattered back, the election on the device
    (voting.elect_on_device: one scoring launch, each voter's tie-break
    jitter from the chunk's draws), aggregation and verification computed
    and kept where an aggregator was found (`torch.where` on the device
    predicate in place of `lax.cond`: the states pass through and the
    weights and scores are zero without one), the quota `agg_count`
    advanced on the device, every client evaluated, and the round's
    outputs written into row r of the chunk's output stack.

A chunk of R rounds is R x (enter, <= E epochs, leave) replays after one
upload of the selections and draws; its outputs come back in one copy
into pinned memory.

The fault hooks of the JAX round body, each built in only when its spec is
given (with none the bodies hold exactly the clean round's ops), take
every per-round value from a [R, ...] buffer the chunk uploads, as the
selections are:

  * `poison` (federation/attack.py): the merged model is tampered with
    between aggregation and verification where the round's attack bit is
    set, with the round's noise row for a noise attack;
  * `chaos` (chaos/): at `leave`, the effective cohort selected ∧
    available ∧ ¬straggler; the lost clients' training is reverted (their
    curves NaN), the vote owner is the first effective selected client,
    voters outside the effective cohort cast no vote, a crash bit fells
    the elected aggregator and the others re-elect (a second
    `elect_on_device` on the same scores with the crashed one masked
    out, its own tie-break draws), the crashed client carries no
    aggregation weight, a client that is down, lost the broadcast or
    crashed keeps its whole state across the merge, and each client's
    distance to the federation's mean model is reported;
  * `elastic` (federation/elastic.py): at `enter`, before the cohort is
    gathered, joining slots take the incumbent-mean params and
    prev_global, joined or left slots get zeroed Adam state, and a
    joiner's verifier history is cleared; retired slots leave the
    effective cohort, receive no broadcast and report NaN metrics.
The epoch body is the same either way: as in the JAX package the whole
selection trains and the lost clients are discarded afterwards.

Clustered federation (cluster/; `cluster_k` > 1 or `personalize`) is built
in the same way. The assignment is a static [N] buffer `cluster_in` that
`dispatch` writes before the chunk's first `enter` (a refit changes the
buffer, never the graphs); K, `personalize` and the shared-module mask are
fixed when the graphs are captured:

  * at `leave`, a voter's candidates are its own cluster's (a voter whose
    cluster has none passes its turn); one product [K, N] x [N, P] merges
    every cluster (cluster.make_clustered_aggregate_fn: the mse_avg dev
    scoring normalized within each cluster, `weights` each client's
    weight in its own cluster's merge); an attack poisons all K merges;
    each client verifies its own cluster's merge ([N, P], one routed
    forward launch), with `personalize` the shared modules' columns only,
    its own post-training params elsewhere; a cluster with no effective
    member has no update, and its clients keep their whole state
    (received ∧ has_update[cluster_in]);
  * at `enter`, an elastic joiner inherits its own cluster's incumbent
    mean, or the fleet's when its cluster has no incumbent.

With `cluster_k` = 1 and no personalization nothing is built: the bodies
are the clean round's op for op.

The red team (redteam/; `redteam` a RedteamFns) is built in the same way,
only when its spec is not null; its per-round inputs are [R, ...] buffers
like the fault hooks': the coalition `rt_adv` [N], the poison rounds'
flag `rt_active` (a captured graph replays both stages every round, so
the schedule is data), the min-tenure gate `rt_vote_ok` [N], and for a
noise poison `rt_update_noise` [N, P] and `rt_merge_noise` [P] ([K·P]
when clustered). At `leave`:

  * the update stage poisons the coalition's rows of the trained params
    (rt_adv x the effective cohort) after the lost clients are reverted
    and before the election and the merge;
  * `rt_vote_ok` gates candidacy and votes in the election and in the
    crash re-election, and with `lie_votes` an adversarial voter picks
    its accomplice (voting.elect_on_device);
  * the merge stage poisons the merge (after the attack's poison, in both
    the single-global and the clustered merge; the victim cluster's row
    only when the spec names one) where the elected aggregator is
    adversarial: `rt_adv[aggregator]` is read only where an aggregator
    was found, and a round without one discards the merge anyway.

Clean, the semantics are the per-phase path's exactly, bit for bit with
the tie-break off; with it on,
the per-phase path draws each voter's uniforms when the voter votes and
the fused one, below the size rule, draws every voter's per round ahead
of it (ExperimentRngs.vote_draws), as the JAX package's fused and
per-phase paths differ only in their key bookkeeping.

A round built with `tie_keys` (above the size rule, voting.
keyed_tie_break: the dense, meshed and batched rounds of a RoundEngine or
BatchedRunEngine, and the tier) holds no [S, N] draws: its tie-break and
its crash re-election read a keyed stream (voting.KeyedDraws), each
round's absolute index and the lanes' absolute client ids uploaded per
chunk into device buffers like the selections, the keys written into
device buffers once (one key per run in the batched round). The election
computes the one row it reads, so the round's tie-break memory is O(N)
at any cohort, as the JAX fused election's `fold_in` per voter is.

The round's ledger (utils/profiling.RoundLedger, always on) records a
timing event on the stream before and after every body replay, between
the graphs and never inside one; the harvest resolves them after its
wait, so nothing waits for the card: each round's device ms of `enter`,
of the epochs that trained, of the speculative epoch and of `leave`, the
card's idle between them, and the train lanes replayed and active
(`utils/profiling.recent_chunks`). While a profiler records, the chunk's
dispatch, uploads, rounds, bodies, flag waits and harvest are program
spans `fused.<name>@<round>` (utils/profiling.span).
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from fedmse_tpu_torch.cluster.merge import (clustered_incumbent_means,
                                            gather_cluster_rows,
                                            personalized_broadcast)
from fedmse_tpu_torch.federation.aggregation import weighted_mean
from fedmse_tpu_torch.federation.attack import PoisonFn
from fedmse_tpu_torch.federation.local_training import (LocalTrainer,
                                                        LocalTrainResult)
from fedmse_tpu_torch.federation.state import (ClientStates,
                                               client_mean_weights,
                                               tree_client_divergence,
                                               tree_select_clients)
from fedmse_tpu_torch.federation.voting import (KeyedDraws, TieBreak,
                                                elect_on_device,
                                                elect_on_device_runs)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.graphs import CapturedBody
from fedmse_tpu_torch.redteam.adversary import RedteamFns
from fedmse_tpu_torch.utils.profiling import RoundLedger, span
from fedmse_tpu_torch.utils.seeding import key_words


class FusedRoundOut(NamedTuple):
    """One round's outputs, on the host (everything the host logs)."""

    aggregator: int          # -1: no aggregator found
    metrics: np.ndarray      # [N] per-client metric ([N, 3] for
                             # metric='classification')
    scores: np.ndarray       # [N] the winning voter's scores (0: none)
    weights: np.ndarray      # [N] aggregation weights (0: no aggregation)
    rejected: np.ndarray     # [N] int32 consecutive rejected broadcasts
    min_valid: np.ndarray    # [N] best local valid loss this round
    tracking: np.ndarray     # [N, E, 3] train/valid loss curves
    # the fault hooks' observables, None where their hook is off:
    eff_mask: Optional[np.ndarray] = None    # [N] effective cohort
    crashed: Optional[int] = None            # crashed aggregator, -1: none
    divergence: Optional[np.ndarray] = None  # [N] distance to the mean
    member: Optional[np.ndarray] = None      # [N] 1 = slot occupied
    generation: Optional[np.ndarray] = None  # [N] tenant generation


@dataclasses.dataclass(frozen=True)
class OutLayout:
    """A round's outputs packed into one f32 row (the aggregator, the
    rejected counters and the hooks' integers are small, exact in f32), so
    a chunk's outputs are one [R, width] stack and one device-to-host
    copy. The hooks' observables have parts only where their hook is on:
    eff_mask under chaos or elastic, crashed and divergence under chaos,
    member and generation under elastic."""

    n: int
    metric_shape: Tuple[int, ...]
    epochs: int
    chaos: bool = False
    elastic: bool = False

    def parts(self) -> List[Tuple[str, Tuple[int, ...]]]:
        n = self.n
        parts = [("aggregator", ()), ("metrics", (n,) + self.metric_shape),
                 ("scores", (n,)), ("weights", (n,)), ("rejected", (n,)),
                 ("min_valid", (n,)), ("tracking", (n, self.epochs, 3))]
        if self.chaos or self.elastic:
            parts.append(("eff_mask", (n,)))
        if self.chaos:
            parts += [("crashed", ()), ("divergence", (n,))]
        if self.elastic:
            parts += [("member", (n,)), ("generation", (n,))]
        return parts

    @property
    def width(self) -> int:
        return sum(int(np.prod(shape)) for _, shape in self.parts())

    def pack(self, **values: torch.Tensor) -> torch.Tensor:
        return torch.cat([values[name].to(torch.float32).reshape(-1)
                          for name, _ in self.parts()])

    def pack_runs(self, runs: int, **values: torch.Tensor) -> torch.Tensor:
        """R runs' rows [R, width], each value with a leading [R] axis."""
        return torch.cat([values[name].to(torch.float32).reshape(runs, -1)
                          for name, _ in self.parts()], dim=1)

    def active_lanes(self, rows: np.ndarray) -> np.ndarray:
        """Per round of a chunk's rows [k, width] (or [k, R, width]): the
        `tracking` entries whose active column is 1, i.e. the train lanes
        in which a selected client trained (NaN rows, unselected, count
        none)."""
        at = 0
        for name, shape in self.parts():
            if name == "tracking":
                break
            at += int(np.prod(shape))
        size = self.n * self.epochs * 3
        block = rows.reshape(rows.shape[0], -1, self.width)[:, :, at:at + size]
        return (block.reshape(rows.shape[0], -1, 3)[:, :, 2] == 1).sum(axis=1)

    def unpack(self, row: np.ndarray) -> FusedRoundOut:
        out, at = {}, 0
        for name, shape in self.parts():
            size = int(np.prod(shape))
            out[name] = row[at:at + size].reshape(shape)
            at += size
        hooks = {}
        if "crashed" in out:
            hooks["crashed"] = int(out.pop("crashed"))
        if "generation" in out:
            hooks["generation"] = out.pop("generation").astype(np.int64)
        return FusedRoundOut(
            aggregator=int(out.pop("aggregator")),
            rejected=out.pop("rejected").astype(np.int32), **out, **hooks)


class FusedRound:
    """The fused round of one engine on static buffers (module docstring).

    `states` becomes the round's state: every round updates its tensors
    in place. `cohort` is S, the selection's size; `capacity` the most
    rounds a chunk holds; `compact` trains the selected clients only
    (else every client, the unselected masked away, as the per-phase
    path); `tie_break` takes each chunk's [R, S, N] uniforms, or with
    `tie_keys` ({"vote": key, "reelect": key}, stream keys of
    utils/seeding.keyed_uniform_row) each round's absolute index and the
    lanes' absolute ids in their place (`dispatch`'s `rounds` and
    `lane_ids`; module docstring). `poison`,
    `chaos` and `elastic` build the fault hooks in (their per-round
    inputs are `dispatch`'s `inputs`, named by `input_names`).
    `cluster_k` > 1 or `personalize` builds clustered federation in:
    `aggregate` is then cluster.make_clustered_aggregate_fn's, `shared`
    the [P] bool mask of the shared modules (cluster.shared_mask), and
    each `dispatch` takes the chunk's assignment `cluster_in`. `redteam`
    (redteam.make_redteam_fns of a non-null spec) builds the red team's
    hooks in."""

    def __init__(self, *, trainer: LocalTrainer, base_scores: Callable,
                 aggregate: Callable, verify: Callable,
                 evaluate_all: Callable, layout: ParamLayout,
                 states: ClientStates, data, ver_x, ver_m,
                 priorities: Optional[torch.Tensor], max_threshold: int,
                 cohort: int, capacity: int, compact: bool,
                 tie_break: bool, metric_shape: Tuple[int, ...],
                 poison: Optional[PoisonFn] = None, chaos: bool = False,
                 elastic: bool = False, cluster_k: int = 1,
                 personalize: bool = False,
                 shared: Optional[torch.Tensor] = None,
                 redteam: Optional[RedteamFns] = None,
                 tie_keys: Optional[Dict[str, Sequence[int]]] = None):
        self.trainer, self.base_scores = trainer, base_scores
        self.aggregate, self.verify = aggregate, verify
        self.evaluate_all, self.layout = evaluate_all, layout
        self.states, self.data = states, data
        self.ver_x, self.ver_m = ver_x, ver_m
        self.priorities, self.max_threshold = priorities, max_threshold
        self.cohort_size, self.capacity = cohort, capacity
        self.compact = compact
        self.poison, self.chaos, self.elastic = poison, chaos, elastic
        self.cluster_k, self.personalize = cluster_k, personalize
        self.clustered = cluster_k > 1 or personalize
        self.redteam = redteam
        if personalize and shared is None:
            raise ValueError("personalize needs the shared-module mask")
        self.shared = shared
        self.tie_keys = tie_keys if tie_break else None
        dev = states.params.device
        self.device = dev
        self._buffers(states.params.shape[0], states.params.shape[1],
                      tie_break, metric_shape)
        cuda = dev.type == "cuda"
        # the early-stop flags come back through pinned memory
        self.go_host = (torch.zeros(trainer.epochs, dtype=torch.bool,
                                    pin_memory=True) if cuda else None)
        self.enter = CapturedBody(self._enter, dev, "enter")
        self.epoch = CapturedBody(lambda: trainer.epoch(self.co), dev,
                                  "epoch")
        self.leave = CapturedBody(self._leave, dev, "leave")
        self.host_reads = 0
        # the epochs each round ran (its speculative no-op epoch not counted)
        self.epochs_run: List[int] = []
        # the flight recorder (utils/profiling.py): markers around every
        # body replay of the chunk being dispatched (`_chunk`), resolved
        # at its harvest (the sharded round's `_replay` records none)
        self.ledger = RoundLedger(dev)
        self._chunk = None
        self._round_at = 0  # the absolute round being dispatched

    def _buffers(self, n: int, p: int, tie_break: bool,
                 metric_shape: Tuple[int, ...]) -> None:
        """The static buffers of N clients' rounds: the chunk's selections
        and draws and the round's slice of them, the quota, the hooks'
        inputs, the cohort's training buffers and the output stack."""
        cap, cohort, dev = self.capacity, self.cohort_size, self.device
        i64 = torch.int64
        self.ids = torch.arange(n, device=dev)
        self.sel_all = torch.zeros((cap, cohort), dtype=i64, device=dev)
        self.slot = torch.zeros((), dtype=i64, device=dev)
        self.agg_count = torch.zeros(n, dtype=torch.int32, device=dev)
        self.sel = torch.zeros(cohort, dtype=i64, device=dev)
        self.sel_mask = torch.zeros(n, device=dev)
        self._tie_buffers(n, tie_break)
        self.cluster_in = (torch.zeros(n, dtype=i64, device=dev)
                           if self.clustered else None)
        self._hook_buffers(n, p, tie_break)
        idx = (torch.zeros(cohort, dtype=i64, device=dev) if self.compact
               else torch.arange(n, device=dev))
        self._cohort_buffers(idx)
        self.out = OutLayout(n, metric_shape, self.trainer.epochs,
                             self.chaos, self.elastic)
        self.out_stack = torch.zeros((cap, self.out.width), device=dev)

    def _tie_buffers(self, width: int, tie_break: bool,
                     runs: Tuple[int, ...] = ()) -> None:
        """The tie-break's buffers over `width` lanes: the chunk's [cap, S,
        width] draws and the round's [S, width] (u_all, u); or, keyed,
        the stream keys ([K] words; [R, K] with `runs` = (R,), each run's
        own key), the chunk's absolute rounds, the round's, and the
        lanes' absolute ids, nothing of size S x width. `runs` = (R,)
        gives the draws a run axis after the chunk's."""
        cap, cohort, dev = self.capacity, self.cohort_size, self.device
        keyed, i64 = self.tie_keys is not None, torch.int64
        dense = tie_break and not keyed
        sheet = runs + (cohort, width)
        self.u_all = (torch.zeros((cap,) + sheet, device=dev)
                      if dense else None)
        self.u = torch.zeros(sheet, device=dev) if dense else None
        self.round_all = (torch.zeros(cap, dtype=i64, device=dev) if keyed
                          else None)
        self.round_t = (torch.zeros((), dtype=i64, device=dev) if keyed
                        else None)
        self.lane_ids = (torch.full((width,), -1, dtype=i64, device=dev)
                         if keyed else None)
        self.tie_key = {name: self._key_words(key).to(dev)
                        for name, key in (self.tie_keys or {}).items()}

    @staticmethod
    def _key_words(key) -> torch.Tensor:
        """A stream key's words int64 [K], or R keys' [R, K]."""
        many = isinstance(key[0], (tuple, list))
        return torch.tensor([key_words(k) for k in key] if many
                            else key_words(key), dtype=torch.int64)

    def set_tie_keys(self, tie_keys: Dict[str, Sequence[int]]) -> None:
        """Point a keyed round at the stream keys of the engine's current
        streams (another run's, after the engine's `rngs` was replaced):
        the key buffers rewritten in place, outside any replay."""
        if tie_keys == self.tie_keys:
            return
        for name, key in tie_keys.items():
            self._up(self.tie_key[name], self._key_words(key))
        self.tie_keys = dict(tie_keys)

    def _draws(self, name: str) -> TieBreak:
        """The tie-break source of the election `name` ("vote" or
        "reelect"): the round's draws, or the keyed stream's."""
        if self.tie_keys is not None:
            return KeyedDraws(self.tie_key[name], self.round_t,
                              self.lane_ids)
        return self.u if name == "vote" else self.round_in.get(
            "reelect_draws")

    def _take_draws(self, at: torch.Tensor) -> None:
        """Round slot `at`'s draws, or its absolute round, into the
        round's buffers."""
        if self.u is not None:
            self.u.copy_(self.u_all.index_select(0, at)[0])
        if self.round_t is not None:
            self.round_t.copy_(self.round_all.index_select(0, at)[0])

    def _cohort_buffers(self, idx: torch.Tensor) -> None:
        d = self.data
        self.co = self.trainer.cohort(idx, self.states.params, d.train_xb,
                                      d.train_mb, d.valid_xb, d.valid_mb)

    def _hook_buffers(self, n: int, p: int, tie_break: bool) -> None:
        """Each built-in hook's [capacity, ...] chunk inputs and the round's
        slice of them, by input name."""
        cap, dev = self.capacity, self.device
        shapes = {}
        if self.poison is not None:
            shapes["attack"] = ((), torch.float32)
            if self.poison.needs_noise:  # one row per merged model
                width = p * self.cluster_k if self.clustered else p
                shapes["noise"] = ((width,), torch.float32)
        if self.chaos:
            shapes.update(available=((n,), torch.float32),
                          straggler=((n,), torch.float32),
                          crash=((), torch.bool),
                          bcast_drop=((n,), torch.float32))
            if tie_break and self.tie_keys is None:
                shapes["reelect_draws"] = ((self.cohort_size, n),
                                           torch.float32)
        if self.elastic:
            shapes.update(member=((n,), torch.float32),
                          joined=((n,), torch.float32),
                          left=((n,), torch.float32),
                          generation=((n,), torch.int32))
        rt = self.redteam
        if rt is not None:
            if rt.spec.attacks:
                shapes.update(rt_adv=((n,), torch.float32),
                              rt_active=((), torch.float32))
            if rt.gate_votes:
                shapes["rt_vote_ok"] = ((n,), torch.float32)
            if rt.needs_noise:
                width = p * self.cluster_k if self.clustered else p
                shapes.update(rt_update_noise=((n, p), torch.float32),
                              rt_merge_noise=((width,), torch.float32))
        self.chunk_in = {k: torch.zeros((cap,) + shape, dtype=dt, device=dev)
                         for k, (shape, dt) in shapes.items()}
        self.round_in = {k: torch.zeros(shape, dtype=dt, device=dev)
                         for k, (shape, dt) in shapes.items()}

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(self.chunk_in)

    @property
    def faults(self) -> bool:
        return self.chaos or self.elastic

    # ---- the three bodies (no host read in any of them) ---- #

    def _enter(self) -> None:
        d, st = self.data, self.states
        at = self.slot.view(1)  # a device index: no host read
        self.sel.copy_(self.sel_all.index_select(0, at)[0])
        self.sel_mask.zero_()
        self.sel_mask.index_fill_(0, self.sel, 1.0)
        if self.compact:
            self.co.idx.copy_(torch.sort(self.sel).values)
        self._take_draws(at)
        for k, buf in self.round_in.items():
            buf.copy_(self.chunk_in[k].index_select(0, at)[0])
        if self.elastic:
            self._join_and_leave()
        self.trainer.begin(self.co, st.params, st.opt_state, st.prev_global,
                           d.train_xb, d.train_mb, d.valid_xb, d.valid_mb)

    def _join_and_leave(self) -> None:
        """The slot pool's entry transitions, in place (JAX fused.py
        round_body's elastic block)."""
        st, r = self.states, self.round_in
        r["member"].mul_(self.data.client_mask)  # padding never joins
        joined, left = r["joined"] > 0, r["left"] > 0
        mean = self._incumbent_mean(st.params,
                                    r["member"] * (1.0 - r["joined"]))
        rows = joined[:, None]
        torch.where(rows, mean, st.params, out=st.params)
        torch.where(rows, mean, st.prev_global, out=st.prev_global)
        reset = joined | left
        for t in st.opt_state:
            t.masked_fill_(reset.view((-1,) + (1,) * (t.dim() - 1)), 0)
        st.hist_params.masked_fill_(rows, 0)
        for t in (st.hist_perf, st.hist_seen, st.rejected, st.waived):
            t.masked_fill_(joined, 0)

    def _incumbent_mean(self, params, incumbents) -> torch.Tensor:
        """A joiner's model: the incumbents' uniform mean [P], or [N, P]
        when clustered (each slot's own cluster's mean)."""
        if self.clustered:
            return clustered_incumbent_means(params, incumbents,
                                             self.cluster_in, self.cluster_k)
        return weighted_mean(params, client_mean_weights(incumbents))

    def _effective(self, res: LocalTrainResult):
        """The effective cohort and the training result with the lost
        clients (selected, not effective) reverted: their params and Adam
        state pass through, their curves are NaN."""
        st, r = self.states, self.round_in
        eff = self.sel_mask
        if self.chaos:
            eff = eff * r["available"] * (1.0 - r["straggler"])
        if self.elastic:
            eff = eff * r["member"]
        lost = (self.sel_mask > 0) & (eff <= 0)
        nan = float("nan")
        return eff, LocalTrainResult(
            params=tree_select_clients(lost, st.params, res.params),
            opt_state=res.opt_state.where(~lost, st.opt_state),
            best_params=res.best_params,
            min_valid=torch.where(lost, nan, res.min_valid),
            tracking=torch.where(lost[:, None, None], nan, res.tracking))

    def _reelect(self, base, eff, aggregator, scores):
        """A crash fells the elected aggregator: the others elect again on
        the same scores. Returns (aggregator, scores, crashed)."""
        r = self.round_in
        crash_now = r["crash"] & (aggregator >= 0)
        mask2 = torch.where(self.ids == aggregator, 0.0, eff)
        again, scores2 = elect_on_device(
            base, self._draws("reelect"), self.sel, mask2, self.agg_count,
            self.max_threshold, voters=mask2, cluster_in=self.cluster_in,
            **self._election_inputs())
        crashed = torch.where(crash_now, aggregator, -1)
        return (torch.where(crash_now, again, aggregator),
                torch.where(crash_now, scores2, scores), crashed)

    def _election_inputs(self) -> dict:
        """The red team's election inputs (none without its hooks)."""
        rt, r = self.redteam, self.round_in
        if rt is None:
            return {}
        return {"vote_ok": r["rt_vote_ok"] if rt.gate_votes else None,
                "adv": r["rt_adv"] if rt.lie_votes else None,
                "lie_votes": rt.lie_votes}

    def _poison_merge(self, merged, aggregator, clustered: bool):
        """The merge stage: merged poisoned where the round is a poison
        round and the elected aggregator is adversarial."""
        r = self.round_in
        found = aggregator >= 0
        at = torch.where(found, aggregator, 0).view(1)
        is_adv = found & (r["rt_adv"].index_select(0, at)[0] > 0)
        noise = r.get("rt_merge_noise")
        if noise is not None and clustered:
            noise = noise.view(self.cluster_k, -1)
        return self.redteam.merge_fn(merged, is_adv, r["rt_active"], noise,
                                     clustered=clustered)

    def _received(self, aggregator, crashed, has_update) -> torch.Tensor:
        """[N] bool: who gets the broadcast. The down, the broadcast-lost,
        the crashed and retired slots do not, nor the clients of a cluster
        that merged nothing; the aggregator holds it."""
        r, got = self.round_in, None
        if self.chaos:
            got = ((r["bcast_drop"] <= 0) & (r["available"] > 0)
                   & (self.ids != crashed))
        if self.elastic:
            got = r["member"] > 0 if got is None else got & (r["member"] > 0)
        if has_update is not None:
            sent = has_update.index_select(0, self.cluster_in)
            got = sent if got is None else got & sent
        return got | (self.ids == aggregator)

    def _merge(self, st, agg_mask, aggregator):
        """(the broadcast: [P], or [N, P] when clustered; weights [N];
        has_update [K] or None)."""
        d, r = self.data, self.round_in
        sel_idx = self.co.idx if self.compact else None
        rt_merge = self.redteam is not None \
            and self.redteam.merge_fn is not None
        if not self.clustered:
            merged, weights = self.aggregate(st.params, agg_mask, d.dev_x,
                                             sel_idx=sel_idx)
            if self.poison is not None:
                merged = self.poison(merged, r["attack"], r.get("noise"))
            if rt_merge:
                merged = self._poison_merge(merged, aggregator, False)
            return merged, weights, None
        merged, weights, has_update = self.aggregate(
            st.params, agg_mask, d.dev_x, self.cluster_in, sel_idx=sel_idx)
        if self.poison is not None:  # every cluster's merge
            noise = r.get("noise")
            merged = self.poison(merged, r["attack"], None if noise is None
                                 else noise.view(self.cluster_k, -1))
        if rt_merge:
            merged = self._poison_merge(merged, aggregator, True)
        bcast = gather_cluster_rows(merged, self.cluster_in)
        if self.personalize:
            bcast = personalized_broadcast(bcast, st.params, self.shared)
        return bcast, weights, has_update

    def _leave(self) -> None:
        d, st, r = self.data, self.states, self.round_in
        res = self.trainer.finish(self.co, st.params, st.opt_state,
                                  self.sel_mask)
        eff = self.sel_mask
        if self.faults:
            eff, res = self._effective(res)
        if self.redteam is not None and self.redteam.update_fn is not None:
            # the coalition's own updates, poisoned before the merge
            res = res._replace(params=self.redteam.update_fn(
                res.params, r["rt_adv"] * eff, r["rt_active"],
                r.get("rt_update_noise")))
        st.params.copy_(res.params)
        st.opt_state.copy_(res.opt_state)
        # the vote tensor: the first (effective) selected client's valid split
        if self.faults:
            first = (eff.index_select(0, self.sel) > 0).to(
                torch.int32).argmax().view(1)
            voter0 = self.sel.index_select(0, first)
        else:
            voter0 = self.sel[:1]
        base = self.base_scores(st.params,
                                d.valid_x.index_select(0, voter0)[0],
                                d.valid_m.index_select(0, voter0)[0])
        aggregator, scores = elect_on_device(
            base, self._draws("vote"), self.sel, eff, self.agg_count,
            self.max_threshold, voters=eff if self.faults else None,
            cluster_in=self.cluster_in, **self._election_inputs())
        crashed, agg_mask = None, eff
        if self.chaos:
            aggregator, scores, crashed = self._reelect(base, eff,
                                                        aggregator, scores)
            agg_mask = torch.where(self.ids == crashed, 0.0, eff)
        won = aggregator >= 0
        merged, weights, has_update = self._merge(st, agg_mask, aggregator)
        is_agg = self.ids == aggregator  # all false for -1
        outcome = self.verify(st, merged, self.ver_x, self.ver_m,
                              is_agg.to(torch.float32), d.client_mask)
        new = outcome.states
        if self.faults or self.clustered:
            new = new.select(self._received(aggregator, crashed,
                                            has_update), st)
        st.where_(won, new)
        self.agg_count += (is_agg & won).to(torch.int32)
        metrics = self.evaluate_all(self.layout.tree(st.params), d.test_x,
                                    d.test_m, d.test_y, d.train_xb,
                                    d.train_mb, priorities=self.priorities)
        hooks = {}
        if self.faults:
            hooks["eff_mask"] = eff
        if self.chaos:
            hooks["crashed"] = crashed
            hooks["divergence"] = tree_client_divergence(st.params,
                                                         d.client_mask)
        if self.elastic:
            present = r["member"] > 0
            metrics = torch.where(present.view((-1,) + (1,) * (
                metrics.dim() - 1)), metrics, float("nan"))
            hooks.update(member=r["member"], generation=r["generation"])
        row = self.out.pack(
            aggregator=aggregator, metrics=metrics, scores=scores,
            weights=torch.where(won, weights, 0.0), rejected=st.rejected,
            min_valid=res.min_valid, tracking=res.tracking, **hooks)
        self.out_stack.index_copy_(0, self.slot.view(1), row[None])
        self.slot += 1

    # ---- the host side ---- #

    def _marker(self):
        """The ledger's marker event, recorded now (None off a card or
        without a chunk being recorded)."""
        return None if self._chunk is None else self._chunk.marker()

    def _mark(self):
        """After an epoch: its flags on their way to the host, behind an
        event (the ledger's epoch end marker when it records)."""
        if self.go_host is None:
            return None
        self.go_host.copy_(self.co.go, non_blocking=True)
        if self._chunk is not None:
            return self._chunk.marker()
        event = torch.cuda.Event()
        event.record()
        return event

    def _go(self, event, e: int) -> bool:
        """Whether some client is active in epoch e + 1: one host read."""
        self.host_reads += 1
        if event is None:
            return bool(self.co.go[e])
        with span("fused.flag_wait", self._round_at):
            event.synchronize()
        return bool(self.go_host[e])

    def _body(self, body: Callable[[], None], name: str,
              end: Optional[Callable] = None):
        """One replay of a body in its span, between two ledger markers
        (the second `end()`'s where given); returns the second."""
        start = self._marker()
        with span("fused." + name, self._round_at):
            body()
        stop = self._marker() if end is None else end()
        if self._chunk is not None:
            self._chunk.body(name, start, stop)
        return stop

    def _epochs(self) -> None:
        marks = [self._body(self.epoch, "epoch", self._mark)]
        ran = 1
        for e in range(1, self.trainer.epochs):
            # speculative until go[e - 1] is read
            marks.append(self._body(self.epoch, "epoch", self._mark))
            if not self._go(marks[e - 1], e - 1):
                break
            ran += 1
        self.epochs_run.append(ran)
        if self._chunk is not None:
            self._chunk.trained(ran)

    def _rounds(self, first: int, k: int) -> None:
        """The bodies of rounds first .. first + k - 1, each in its span."""
        for i in range(k):
            self._round_at = first + i
            with span("fused.round", self._round_at):
                self._body(self.enter, "enter")
                self._epochs()
                self._body(self.leave, "leave")

    def dispatch(self, schedule: Sequence[Sequence[int]],
                 draws: Optional[torch.Tensor],
                 agg_count: Optional[np.ndarray],
                 inputs: Optional[Dict[str, np.ndarray]] = None,
                 cluster_in: Optional[np.ndarray] = None,
                 rounds: Optional[Sequence[int]] = None,
                 lane_ids: Optional[np.ndarray] = None,
                 start_round: int = 0) -> Callable[[], list]:
        """Run len(schedule) rounds: upload the selections and draws, the
        hooks' `inputs` ([k, ...] each, by `input_names`), the assignment
        [N] of a clustered round, and the quota (unless None: then the
        device carries it from the last chunk), replay the bodies round by
        round and start one copy of the output stack to the host. A keyed
        round (`tie_keys`) takes the rounds' absolute indices `rounds`
        and the lanes' absolute ids `lane_ids` [N] (-1: a pad lane) in
        place of `draws`. `start_round` is the chunk's first absolute round
        (the ledger's and the spans' index). Returns the harvest: a call
        that waits for that copy and returns the rounds' FusedRoundOuts."""
        k = len(schedule)
        if k > self.capacity or any(len(s) != self.cohort_size
                                    for s in schedule):
            raise ValueError(f"a chunk of {k} rounds of {self.cohort_size} "
                             f"clients each fits this round's buffers; got "
                             f"{[len(s) for s in schedule]}")
        if self.clustered != (cluster_in is not None):
            raise ValueError("a clustered round takes the assignment "
                             "cluster_in, and only a clustered round does")
        with span("fused.dispatch", start_round):
            with span("fused.upload", start_round):
                self._upload_keyed(k, draws, rounds, lane_ids)
                self._upload(schedule, draws, agg_count, inputs)
                if cluster_in is not None:
                    self._up(self.cluster_in, torch.as_tensor(
                        np.asarray(cluster_in, dtype=np.int64)))
            return self._replay(start_round, k, lambda rows: [
                self.out.unpack(row) for row in rows])

    def _upload_keyed(self, k: int, draws, rounds, lane_ids) -> None:
        """A keyed round's k absolute rounds and the lanes' ids into their
        buffers. A keyed round takes no draws, and only a keyed round
        takes rounds and lane ids."""
        keyed = self.tie_keys is not None
        if keyed != (rounds is not None and lane_ids is not None) or (
                keyed and draws is not None):
            raise ValueError("a keyed tie-break takes the rounds and the "
                             "lane ids and no draws, and only a keyed one "
                             "takes rounds and lane ids")
        if keyed:
            if len(rounds) != k:
                raise ValueError(f"{len(rounds)} absolute rounds for a "
                                 f"chunk of {k}")
            self._up(self.round_all[:k], torch.as_tensor(
                np.asarray(rounds, dtype=np.int64)))
            self._up(self.lane_ids, torch.as_tensor(
                np.asarray(lane_ids, dtype=np.int64)))

    def _up(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """A host tensor into a device buffer (through pinned memory on the
        card, without waiting)."""
        cuda = self.device.type == "cuda"
        dst.copy_(src.pin_memory() if cuda else src, non_blocking=cuda)

    def _upload(self, schedule, draws, agg_count, inputs) -> None:
        """A chunk's selections, draws, quota (unless None) and the hooks'
        inputs into the chunk buffers."""
        inputs = inputs or {}
        if set(inputs) != set(self.chunk_in):
            raise ValueError(f"this round's hooks take inputs "
                             f"{sorted(self.chunk_in)}; got {sorted(inputs)}")
        k = len(schedule)
        self._up(self.sel_all[:k], torch.tensor(schedule, dtype=torch.int64))
        if self.u_all is not None:
            self._up(self.u_all[:k], draws)
        for name, value in inputs.items():
            buf = self.chunk_in[name][:k]
            self._up(buf, torch.as_tensor(np.array(value)).to(
                buf.dtype).reshape(buf.shape))
        if agg_count is not None:
            self._up(self.agg_count, torch.as_tensor(
                np.asarray(agg_count, dtype=np.int32)))

    def _replay(self, first: int, k: int,
                unpack: Callable[[np.ndarray], list]) -> Callable[[], list]:
        """Replay the bodies round by round for k rounds from the absolute
        round `first` and start one copy of the output stack to the host;
        returns the harvest, which waits for that copy, resolves the
        chunk's ledger record and unpacks the rows."""
        self.slot.zero_()
        chunk = self._chunk = self.ledger.open(first, self.co.p.shape[0])
        try:
            self._rounds(first, k)
        finally:
            self._chunk = None
        chunk.sealed()
        if self.device.type == "cuda":
            host = torch.empty(tuple(self.out_stack[:k].shape),
                               pin_memory=True)
            host.copy_(self.out_stack[:k], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = self.out_stack[:k].clone(), None

        def harvest() -> list:
            with span("fused.harvest", first):
                if done is not None:
                    done.synchronize()
                rows = host.numpy()
                chunk.close(self.out.active_lanes(rows))
                return unpack(rows)

        return harvest

    def stats(self) -> dict:
        """The graphs' replays, nodes and capture seconds, the host's flag
        reads and the epochs each round ran."""
        return {"graphs": {b.name: b.stats() for b in
                           (self.enter, self.epoch, self.leave)},
                "host_reads": self.host_reads,
                "epochs_run": list(self.epochs_run)}


class BatchedFusedRound(FusedRound):
    """R independent federations' fused rounds in one set of bodies (port of
    fedmse_tpu/federation/fused.py `make_batched_runs_scan`; the engine is
    federation/batched.py).

    The R runs stack run by run on the client axis: `states` is [R·N, P]
    (run r's client i at row r N + i) and `data` the federation tiled R
    times (batched.tile_federated_data). Every body works on the R·N
    rows, so each step is one train-kernel launch at G = R·S (with one
    run's CTAs per client, LocalTrainer.ctas) and each scoring one
    forward launch over the R·N routed models. What is per run stays per
    run:

      * the selections [R, S] (each run's own client ids), the tie-break
        draws [R, S, N] (keyed: each run's own key [R, K], the rounds and
        lanes shared) and the quota `agg_count` [R, N];
      * the vote tensor (each run's first effective selected client's
        valid split), and the election (voting.elect_on_device_runs: each
        run's winning voter's row only); a crash bit [R] per run;
      * the merge (aggregation.make_runs_aggregate_fn: the dev scoring one
        launch, each run normalized and merged on its own rows), then
        each client verifies its own run's merge ([R·N, P], one routed
        forward launch);
      * an elastic joiner's incumbent mean and the chaos divergence, over
        its own run's slots;
      * `active` [R]: a stopped run's lane still launches, but `leave`
        puts its whole state back from the round's entry copy
        (ClientStates.where_, a select: NaN stays NaN, nothing is
        multiplied by 0) and its quota does not move, so its federation
        is frozen bit for bit.

    Keyed (`tie_keys` {"vote": [R keys], "reelect": [R keys]}, each run's
    vote_key() / reelect_key()), every run's election computes its own
    winning voter's row: no [R, S, N] buffer exists.

    The outputs are [R] rows per round: the harvest returns, per round,
    each run's FusedRoundOut. Clustering and the red team are refused
    here, as the JAX package's batched runs refuse them."""

    def __init__(self, *, runs: int, **kw):
        if kw.get("cluster_k", 1) > 1 or kw.get("personalize") \
                or kw.get("redteam") is not None:
            raise ValueError("batched runs are neither clustered nor "
                             "attacked by the red team")
        self.runs = runs
        super().__init__(**kw)

    def _buffers(self, rows: int, p: int, tie_break: bool,
                 metric_shape: Tuple[int, ...]) -> None:
        """FusedRound._buffers of R runs: the selections, draws, quota and
        output rows per run, the hooks' inputs per client or per run, the
        cohort of every run's selection, and the round's entry state."""
        runs, cap, cohort = self.runs, self.capacity, self.cohort_size
        dev, i64 = self.device, torch.int64
        if rows % runs:
            raise ValueError(f"{rows} state rows are not {runs} runs")
        n = self.n = rows // runs
        self.ids = torch.arange(rows, device=dev)
        self.local_ids = torch.arange(n, device=dev)
        self.run_of = torch.arange(runs, device=dev).repeat_interleave(n)
        self.offset = torch.arange(runs, device=dev) * n
        self.sel_all = torch.zeros((cap, runs, cohort), dtype=i64,
                                   device=dev)
        self._tie_buffers(n, tie_break, runs=(runs,))
        self.active_all = torch.zeros((cap, runs), dtype=torch.bool,
                                      device=dev)
        self.slot = torch.zeros((), dtype=i64, device=dev)
        self.agg_count = torch.zeros((runs, n), dtype=torch.int32,
                                     device=dev)
        self.sel = torch.zeros((runs, cohort), dtype=i64, device=dev)
        self.sel_rows = torch.zeros(runs * cohort, dtype=i64, device=dev)
        self.sel_mask = torch.zeros(rows, device=dev)
        self.active = torch.zeros(runs, dtype=torch.bool, device=dev)
        self._hook_buffers(n, p, tie_break)
        self._cohort_buffers(
            torch.zeros(runs * cohort, dtype=i64, device=dev)
            if self.compact else torch.arange(rows, device=dev))
        self.entry = self.states.clone()  # the round's entry state
        self.out = OutLayout(n, metric_shape, self.trainer.epochs,
                             self.chaos, self.elastic)
        self.out_stack = torch.zeros((cap, runs, self.out.width),
                                     device=dev)

    def _hook_buffers(self, n: int, p: int, tie_break: bool) -> None:
        """The hooks' [capacity, ...] chunk inputs: per client [R·N] (a
        run's N slots after another's), per run [R] for the crash bit,
        [R, S, N] for the re-election's draws (none when keyed) and [R, P]
        for the attack noise; the attack bit is one per round."""
        cap, dev, runs = self.capacity, self.device, self.runs
        rows = runs * n
        shapes = {}
        if self.poison is not None:
            shapes["attack"] = ((), torch.float32)
            if self.poison.needs_noise:
                shapes["noise"] = ((runs, p), torch.float32)
        if self.chaos:
            shapes.update(available=((rows,), torch.float32),
                          straggler=((rows,), torch.float32),
                          crash=((runs,), torch.bool),
                          bcast_drop=((rows,), torch.float32))
            if tie_break and self.tie_keys is None:
                shapes["reelect_draws"] = ((runs, self.cohort_size, n),
                                           torch.float32)
        if self.elastic:
            shapes.update(member=((rows,), torch.float32),
                          joined=((rows,), torch.float32),
                          left=((rows,), torch.float32),
                          generation=((rows,), torch.int32))
        self.chunk_in = {k: torch.zeros((cap,) + shape, dtype=dt, device=dev)
                         for k, (shape, dt) in shapes.items()}
        self.round_in = {k: torch.zeros(shape, dtype=dt, device=dev)
                         for k, (shape, dt) in shapes.items()}

    def _enter(self) -> None:
        d, st = self.data, self.states
        at = self.slot.view(1)
        self.entry.copy_(st)
        self.sel.copy_(self.sel_all.index_select(0, at)[0])
        self.sel_rows.copy_((self.sel + self.offset[:, None]).view(-1))
        self.sel_mask.zero_()
        self.sel_mask.index_fill_(0, self.sel_rows, 1.0)
        if self.compact:
            self.co.idx.copy_(torch.sort(self.sel_rows).values)
        self._take_draws(at)
        self.active.copy_(self.active_all.index_select(0, at)[0])
        for k, buf in self.round_in.items():
            buf.copy_(self.chunk_in[k].index_select(0, at)[0])
        if self.elastic:
            self._join_and_leave()
        self.trainer.begin(self.co, st.params, st.opt_state, st.prev_global,
                           d.train_xb, d.train_mb, d.valid_xb, d.valid_mb)

    def _incumbent_mean(self, params, incumbents) -> torch.Tensor:
        """[R·N, P]: each slot's own run's incumbent mean."""
        means = torch.stack([
            weighted_mean(p, client_mean_weights(w)) for p, w in
            zip(params.chunk(self.runs), incumbents.chunk(self.runs))])
        return means.index_select(0, self.run_of)

    def _per_row(self, per_run: torch.Tensor) -> torch.Tensor:
        """A run's value [R] on each of its rows [R·N]."""
        return per_run.index_select(0, self.run_of)

    def _leave(self) -> None:
        d, st, r = self.data, self.states, self.round_in
        runs, n = self.runs, self.n
        res = self.trainer.finish(self.co, st.params, st.opt_state,
                                  self.sel_mask)
        eff = self.sel_mask
        if self.faults:
            eff, res = self._effective(res)
        st.params.copy_(res.params)
        st.opt_state.copy_(res.opt_state)
        eff_r = eff.view(runs, n)
        # each run's vote tensor: its first (effective) selected client's
        if self.faults:
            first = (eff_r.gather(1, self.sel) > 0).to(torch.int32).argmax(
                dim=1, keepdim=True)
            voter0 = self.sel.gather(1, first)[:, 0] + self.offset
        else:
            voter0 = self.sel[:, 0] + self.offset
        base = self.base_scores(st.params, d.valid_x.index_select(0, voter0),
                                d.valid_m.index_select(0, voter0))
        base = base.view(runs, n)
        voters = eff_r if self.faults else None
        aggregator, scores = elect_on_device_runs(
            base, self._draws("vote"), self.sel, eff_r, self.agg_count,
            self.max_threshold, voters=voters)
        crashed, agg_mask = None, eff_r
        if self.chaos:
            crash_now = r["crash"] & (aggregator >= 0)
            mask2 = torch.where(self.local_ids[None, :] == aggregator[:, None],
                                0.0, eff_r)
            again, scores2 = elect_on_device_runs(
                base, self._draws("reelect"), self.sel, mask2,
                self.agg_count, self.max_threshold, voters=mask2)
            crashed = torch.where(crash_now, aggregator, -1)
            aggregator = torch.where(crash_now, again, aggregator)
            scores = torch.where(crash_now[:, None], scores2, scores)
            agg_mask = torch.where(
                self.local_ids[None, :] == crashed[:, None], 0.0, eff_r)
        won = aggregator >= 0  # [R]
        merged, weights = self.aggregate(
            st.params, agg_mask.reshape(-1), d.dev_x,
            sel_idx=self.co.idx if self.compact else None)
        if self.poison is not None:
            merged = self.poison(merged, r["attack"], r.get("noise"))
        is_agg = self.local_ids[None, :] == aggregator[:, None]  # [R, N]
        outcome = self.verify(st, merged.index_select(0, self.run_of),
                              self.ver_x, self.ver_m,
                              is_agg.reshape(-1).to(torch.float32),
                              d.client_mask)
        new = outcome.states
        if self.faults:
            new = new.select(self._received_runs(aggregator, crashed), st)
        live = won & self.active
        st.where_(self._per_row(live), new)
        st.where_(self._per_row(~self.active), self.entry)  # frozen runs
        self.agg_count += (is_agg & live[:, None]).to(torch.int32)
        metrics = self.evaluate_all(self.layout.tree(st.params), d.test_x,
                                    d.test_m, d.test_y, d.train_xb,
                                    d.train_mb, priorities=self.priorities)
        hooks = {}
        if self.faults:
            hooks["eff_mask"] = eff
        if self.chaos:
            hooks["crashed"] = crashed
            hooks["divergence"] = torch.cat([
                tree_client_divergence(p, m) for p, m in
                zip(st.params.chunk(runs), d.client_mask.chunk(runs))])
        if self.elastic:
            present = r["member"] > 0
            metrics = torch.where(present.view((-1,) + (1,) * (
                metrics.dim() - 1)), metrics, float("nan"))
            hooks.update(member=r["member"], generation=r["generation"])
        rows = self.out.pack_runs(
            runs, aggregator=aggregator, metrics=metrics, scores=scores,
            weights=torch.where(self._per_row(won), weights, 0.0),
            rejected=st.rejected, min_valid=res.min_valid,
            tracking=res.tracking, **hooks)
        self.out_stack.index_copy_(0, self.slot.view(1), rows[None])
        self.slot += 1

    def _received_runs(self, aggregator, crashed) -> torch.Tensor:
        """[R·N] bool: who gets its run's broadcast (FusedRound._received,
        run by run)."""
        r, got = self.round_in, None

        def rows(local):  # a per-run client id [R] as its row, -1 kept
            return self._per_row(torch.where(local >= 0, local + self.offset,
                                             -1))
        if self.chaos:
            got = ((r["bcast_drop"] <= 0) & (r["available"] > 0)
                   & (self.ids != rows(crashed)))
        if self.elastic:
            got = r["member"] > 0 if got is None else got & (r["member"] > 0)
        return got | (self.ids == rows(aggregator))

    def dispatch(self, schedule: Sequence[Sequence[Sequence[int]]],
                 draws: Optional[torch.Tensor],
                 agg_count: Optional[np.ndarray],
                 active: np.ndarray,
                 inputs: Optional[Dict[str, np.ndarray]] = None,
                 rounds: Optional[Sequence[int]] = None,
                 lane_ids: Optional[np.ndarray] = None,
                 start_round: int = 0) -> Callable[[], list]:
        """Run len(schedule) rounds of every run: schedule [k][R][S] (each
        run's own client ids), draws [k, R, S, N] or None, the quota [R, N]
        (None: the device carries it from the last chunk), `active` [k, R]
        bool (a False freezes run r at round i) and the hooks' inputs ([k,
        R, ...] each); a keyed round takes the rounds' absolute indices
        `rounds` (every run's) and the lanes' ids `lane_ids` [N] in place
        of `draws`. Returns the harvest: per round, the R runs'
        FusedRoundOuts."""
        k = len(schedule)
        if k > self.capacity or any(
                len(s) != self.runs or any(len(c) != self.cohort_size
                                           for c in s) for s in schedule):
            raise ValueError(f"a chunk of {k} rounds of {self.runs} runs x "
                             f"{self.cohort_size} clients fits these "
                             f"buffers")
        with span("fused.dispatch", start_round):
            with span("fused.upload", start_round):
                self._upload_keyed(k, draws, rounds, lane_ids)
                self._upload(schedule, draws, agg_count, inputs)
                self._up(self.active_all[:k], torch.as_tensor(
                    np.array(active, dtype=bool)))
            return self._replay(start_round, k, lambda rows: [
                [self.out.unpack(row) for row in runs] for runs in rows])


# the hooks' inputs with a leading client axis [N, ...]; the others are
# per round (scalars, the merge's noise, the re-election's [S, N] draws)
CLIENT_INPUTS = ("available", "straggler", "bcast_drop", "member", "joined",
                 "left", "generation", "rt_adv", "rt_vote_ok",
                 "rt_update_noise")


def gather_vote_rows(mesh, data, lo: int, voter0: torch.Tensor):
    """The valid split of client voter0 ([1] global id, on the device)
    from the rank of `mesh` that owns it, on every rank: each rank offers
    its block's row (the block starts at `lo`) at voter0's local index
    (clamped), and the owner's is taken. No host read: it runs inside a
    captured body too."""
    n = data.valid_x.shape[0]
    owner = torch.div(voter0, n, rounding_mode="floor")
    local = torch.clamp(voter0 - lo, 0, n - 1)
    x = mesh.all_gather(data.valid_x.index_select(0, local)[0])
    m = mesh.all_gather(data.valid_m.index_select(0, local)[0])
    return x.index_select(0, owner)[0], m.index_select(0, owner)[0]


class ShardedFusedRound(FusedRound):
    """The fused round of one rank of a client mesh (parallel/; the port of
    the JAX round sharded P('clients') over a mesh). The rank holds the
    block [lo, hi) of the padded client axis N: `states` and `data` are
    its rows (the dev set whole), and training, verification and
    evaluation run on them alone, every client of the block trained and
    the unselected masked away (`compact` is off on a sharded axis, as in
    the JAX engine). What crosses ranks is an all-gather
    (ClientMesh.all_gather) at each point where the round needs the fleet:

      * the vote: the first (effective) selected client's valid split,
        from its owner; each rank's [n] base scores, gathered to [N];
      * the election, then, on every rank alike on the same bits
        (voting.elect_on_device with the chunk's selections, draws, quota
        and masks, all fleet-wide): no broadcast;
      * the merge (`aggregate`, from parallel/collectives.py), the chaos
        axis's mean model (`divergence`) and an elastic joiner's
        incumbent mean, as gathered partials summed in rank order;
      * the chunk's outputs, gathered once at the chunk's end (each rank
        packs its rows; the harvest assembles the fleet's, the same on
        every rank).

    On the card each body is a CapturedBody (ops/graphs.py): the
    graphs between the collectives are captured, and the collectives are
    eager calls between replays, on NCCL or gloo alike. The hooks'
    per-client inputs stay fleet-wide [N] buffers (the election reads
    them whole); the round reads its block through views."""

    def __init__(self, *, mesh, divergence: Optional[Callable] = None,
                 n_global: int, **kw):
        self.mesh = mesh
        self.n_global = n_global
        self.lo, self.hi = mesh.block(n_global)
        self.divergence = divergence
        if kw.get("compact"):
            raise ValueError("a sharded client axis trains its block "
                             "masked: compact=False")
        super().__init__(**kw)

    def _buffers(self, n: int, p: int, tie_break: bool,
                 metric_shape: Tuple[int, ...]) -> None:
        cap, cohort, dev = self.capacity, self.cohort_size, self.device
        big, i64 = self.n_global, torch.int64
        if n != self.hi - self.lo:
            raise ValueError(f"a rank's states hold {n} rows; its block of "
                             f"{big} is [{self.lo}, {self.hi})")
        self.ids = torch.arange(big, device=dev)
        self.local_ids = torch.arange(self.lo, self.hi, device=dev)
        self.sel_all = torch.zeros((cap, cohort), dtype=i64, device=dev)
        self.slot = torch.zeros((), dtype=i64, device=dev)
        self.agg_count = torch.zeros(big, dtype=torch.int32, device=dev)
        self.sel = torch.zeros(cohort, dtype=i64, device=dev)
        self.sel_mask_all = torch.zeros(big, device=dev)
        self.sel_mask = self.sel_mask_all[self.lo:self.hi]
        self._tie_buffers(big, tie_break)
        self.cluster_in = (torch.zeros(big, dtype=i64, device=dev)
                           if self.clustered else None)
        self.cluster_local = (self.cluster_in[self.lo:self.hi]
                              if self.clustered else None)
        self._hook_buffers(big, p, tie_break)
        self.local_in = {k: v[self.lo:self.hi]
                         for k, v in self.round_in.items()
                         if k in CLIENT_INPUTS}
        self._cohort_buffers(torch.arange(n, device=dev))
        self.out = OutLayout(n, metric_shape, self.trainer.epochs,
                             self.chaos, self.elastic)
        self.out_all = OutLayout(big, metric_shape, self.trainer.epochs,
                                 self.chaos, self.elastic)
        self.out_stack = torch.zeros((cap, self.out.width), device=dev)

    # ---- the bodies ---- #

    def _enter(self) -> None:
        d, st = self.data, self.states
        at = self.slot.view(1)
        self.sel.copy_(self.sel_all.index_select(0, at)[0])
        self.sel_mask_all.zero_()
        self.sel_mask_all.index_fill_(0, self.sel, 1.0)
        self._take_draws(at)
        for k, buf in self.round_in.items():
            buf.copy_(self.chunk_in[k].index_select(0, at)[0])
        if self.elastic:
            self._join_and_leave()
        self.trainer.begin(self.co, st.params, st.opt_state, st.prev_global,
                           d.train_xb, d.train_mb, d.valid_xb, d.valid_mb)

    def _join_and_leave(self) -> None:
        st, r, loc = self.states, self.round_in, self.local_in
        # padding never joins (the mask is a buffer: a tier rewrites it)
        r["member"].mul_(self.mesh.all_gather(
            self.data.client_mask).reshape(-1))
        joined, left = loc["joined"] > 0, loc["left"] > 0
        incumbents = r["member"] * (1.0 - r["joined"])
        mean = self._incumbent_mean(st.params, incumbents)
        rows = joined[:, None]
        torch.where(rows, mean, st.params, out=st.params)
        torch.where(rows, mean, st.prev_global, out=st.prev_global)
        reset = joined | left
        for t in st.opt_state:
            t.masked_fill_(reset.view((-1,) + (1,) * (t.dim() - 1)), 0)
        st.hist_params.masked_fill_(rows, 0)
        for t in (st.hist_perf, st.hist_seen, st.rejected, st.waived):
            t.masked_fill_(joined, 0)

    def _incumbent_mean(self, params, incumbents) -> torch.Tensor:
        """The joiners' model from the fleet's incumbents [N]: [P], or this
        rank's rows [n, P] when clustered."""
        from fedmse_tpu_torch.parallel.collectives import (
            sharded_clustered_incumbent_means, sharded_weighted_mean)
        if self.clustered:
            return sharded_clustered_incumbent_means(
                self.mesh, params, incumbents, self.cluster_in,
                self.cluster_k)
        w = client_mean_weights(incumbents)[self.lo:self.hi]
        return sharded_weighted_mean(self.mesh, params, w)

    def _effective_all(self) -> torch.Tensor:
        """The fleet's effective cohort [N]."""
        r = self.round_in
        eff = self.sel_mask_all
        if self.chaos:
            eff = eff * r["available"] * (1.0 - r["straggler"])
        if self.elastic:
            eff = eff * r["member"]
        return eff

    def _received_local(self, aggregator, crashed, has_update):
        r, got = self.local_in, None
        if self.chaos:
            got = ((r["bcast_drop"] <= 0) & (r["available"] > 0)
                   & (self.local_ids != crashed))
        if self.elastic:
            got = r["member"] > 0 if got is None else got & (r["member"] > 0)
        if has_update is not None:
            sent = has_update.index_select(0, self.cluster_local)
            got = sent if got is None else got & sent
        return got | (self.local_ids == aggregator)

    def _merge_local(self, st, agg_mask, aggregator):
        d, r = self.data, self.round_in
        rt_merge = self.redteam is not None \
            and self.redteam.merge_fn is not None
        if not self.clustered:
            merged, weights = self.aggregate(st.params, agg_mask, d.dev_x)
            if self.poison is not None:
                merged = self.poison(merged, r["attack"], r.get("noise"))
            if rt_merge:
                merged = self._poison_merge(merged, aggregator, False)
            return merged, weights, None
        merged, weights, has_update = self.aggregate(
            st.params, agg_mask, d.dev_x, self.cluster_local)
        if self.poison is not None:
            noise = r.get("noise")
            merged = self.poison(merged, r["attack"], None if noise is None
                                 else noise.view(self.cluster_k, -1))
        if rt_merge:
            merged = self._poison_merge(merged, aggregator, True)
        bcast = gather_cluster_rows(merged, self.cluster_local)
        if self.personalize:
            bcast = personalized_broadcast(bcast, st.params, self.shared)
        return bcast, weights, has_update

    def _leave(self) -> None:
        d, st, r, loc = self.data, self.states, self.round_in, self.local_in
        lo, hi = self.lo, self.hi
        res = self.trainer.finish(self.co, st.params, st.opt_state,
                                  self.sel_mask)
        eff_all = self.sel_mask_all
        if self.faults:
            eff_all = self._effective_all()
        eff = eff_all[lo:hi]
        if self.faults:
            lost = (self.sel_mask > 0) & (eff <= 0)
            nan = float("nan")
            res = LocalTrainResult(
                params=tree_select_clients(lost, st.params, res.params),
                opt_state=res.opt_state.where(~lost, st.opt_state),
                best_params=res.best_params,
                min_valid=torch.where(lost, nan, res.min_valid),
                tracking=torch.where(lost[:, None, None], nan, res.tracking))
        if self.redteam is not None and self.redteam.update_fn is not None:
            res = res._replace(params=self.redteam.update_fn(
                res.params, loc["rt_adv"] * eff, r["rt_active"],
                loc.get("rt_update_noise")))
        st.params.copy_(res.params)
        st.opt_state.copy_(res.opt_state)
        if self.faults:
            first = (eff_all.index_select(0, self.sel) > 0).to(
                torch.int32).argmax().view(1)
            voter0 = self.sel.index_select(0, first)
        else:
            voter0 = self.sel[:1]
        vote_x, vote_m = gather_vote_rows(self.mesh, self.data, self.lo,
                                          voter0)
        base = self.mesh.all_gather(
            self.base_scores(st.params, vote_x, vote_m)).reshape(-1)
        aggregator, scores = elect_on_device(
            base, self._draws("vote"), self.sel, eff_all, self.agg_count,
            self.max_threshold, voters=eff_all if self.faults else None,
            cluster_in=self.cluster_in, **self._election_inputs())
        crashed, agg_mask = None, eff
        if self.chaos:
            aggregator, scores, crashed = self._reelect(base, eff_all,
                                                        aggregator, scores)
            agg_mask = torch.where(self.local_ids == crashed, 0.0, eff)
        won = aggregator >= 0
        merged, weights, has_update = self._merge_local(st, agg_mask,
                                                        aggregator)
        is_agg = self.local_ids == aggregator
        outcome = self.verify(st, merged, self.ver_x, self.ver_m,
                              is_agg.to(torch.float32), d.client_mask)
        new = outcome.states
        if self.faults or self.clustered:
            new = new.select(self._received_local(aggregator, crashed,
                                                  has_update), st)
        st.where_(won, new)
        self.agg_count += ((self.ids == aggregator) & won).to(torch.int32)
        metrics = self.evaluate_all(self.layout.tree(st.params), d.test_x,
                                    d.test_m, d.test_y, d.train_xb,
                                    d.train_mb, priorities=self.priorities)
        hooks = {}
        if self.faults:
            hooks["eff_mask"] = eff
        if self.chaos:
            hooks["crashed"] = crashed
            hooks["divergence"] = self.divergence(st.params, d.client_mask)
        if self.elastic:
            present = loc["member"] > 0
            metrics = torch.where(present.view((-1,) + (1,) * (
                metrics.dim() - 1)), metrics, float("nan"))
            hooks.update(member=loc["member"], generation=loc["generation"])
        row = self.out.pack(
            aggregator=aggregator, metrics=metrics, scores=scores[lo:hi],
            weights=torch.where(won, weights, 0.0), rejected=st.rejected,
            min_valid=res.min_valid, tracking=res.tracking, **hooks)
        self.out_stack.index_copy_(0, self.slot.view(1), row[None])
        self.slot += 1

    # ---- the host side ---- #

    def _assemble(self, rows: np.ndarray) -> FusedRoundOut:
        """One round's FusedRoundOut of the fleet from the ranks' packed
        rows [W, width]: per-client parts concatenated in rank order, the
        scalars rank 0's (every rank's are the same)."""
        parts, at = {}, 0
        for name, shape in self.out.parts():
            size = int(np.prod(shape))
            block = rows[:, at:at + size].reshape((rows.shape[0],) + shape)
            parts[name] = block[0] if shape == () else np.concatenate(
                list(block), axis=0)
            at += size
        flat = np.concatenate([parts[name].reshape(-1)
                               for name, _ in self.out_all.parts()])
        return self.out_all.unpack(flat)

    def _replay(self, first: int, k: int,
                unpack: Callable[[np.ndarray], list]) -> Callable[[], list]:
        """The bodies for k rounds, then the ranks' output rows gathered
        (one collective, every rank together): at world > 1 the harvest is
        synchronous, as the JAX package's multi-process seam is. The
        spans are the dense round's; the ledger records nothing here."""
        self.slot.zero_()
        self._rounds(first, k)
        rows = self.mesh.all_gather(self.out_stack[:k]).cpu().numpy()
        outs = [self._assemble(rows[:, i]) for i in range(k)]
        return lambda: outs
