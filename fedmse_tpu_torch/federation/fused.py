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
into pinned memory. The chaos, elastic, cluster, red-team, poison and
divergence hooks of the JAX round body are not ported (RoundEngine
raises on them, as the per-phase engine does). Semantics are the
per-phase path's exactly, bit for bit with the tie-break off; with it on,
the per-phase path draws each voter's uniforms when the voter votes and
the fused one draws every voter's per round ahead of it
(ExperimentRngs.vote_draws), as the JAX package's fused and per-phase
paths differ only in their key bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.federation.local_training import LocalTrainer
from fedmse_tpu_torch.federation.state import ClientStates
from fedmse_tpu_torch.federation.voting import elect_on_device
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.graphs import CapturedBody


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


@dataclasses.dataclass(frozen=True)
class OutLayout:
    """A round's outputs packed into one f32 row (the aggregator and the
    rejected counters are small integers, exact in f32), so a chunk's
    outputs are one [R, width] stack and one device-to-host copy."""

    n: int
    metric_shape: Tuple[int, ...]
    epochs: int

    def parts(self) -> List[Tuple[str, Tuple[int, ...]]]:
        n = self.n
        return [("aggregator", ()), ("metrics", (n,) + self.metric_shape),
                ("scores", (n,)), ("weights", (n,)), ("rejected", (n,)),
                ("min_valid", (n,)), ("tracking", (n, self.epochs, 3))]

    @property
    def width(self) -> int:
        return sum(int(np.prod(shape)) for _, shape in self.parts())

    def pack(self, **values: torch.Tensor) -> torch.Tensor:
        return torch.cat([values[name].to(torch.float32).reshape(-1)
                          for name, _ in self.parts()])

    def unpack(self, row: np.ndarray) -> FusedRoundOut:
        out, at = {}, 0
        for name, shape in self.parts():
            size = int(np.prod(shape))
            out[name] = row[at:at + size].reshape(shape)
            at += size
        return FusedRoundOut(
            aggregator=int(out["aggregator"]), metrics=out["metrics"],
            scores=out["scores"], weights=out["weights"],
            rejected=out["rejected"].astype(np.int32),
            min_valid=out["min_valid"], tracking=out["tracking"])


class FusedRound:
    """The fused round of one engine on static buffers (module docstring).

    `states` becomes the round's state: every round updates its tensors
    in place. `cohort` is S, the selection's size; `capacity` the most
    rounds a chunk holds; `compact` trains the selected clients only
    (else every client, the unselected masked away, as the per-phase
    path); `tie_break` takes each chunk's [R, S, N] uniforms."""

    def __init__(self, *, trainer: LocalTrainer, base_scores: Callable,
                 aggregate: Callable, verify: Callable,
                 evaluate_all: Callable, layout: ParamLayout,
                 states: ClientStates, data, ver_x, ver_m,
                 priorities: Optional[torch.Tensor], max_threshold: int,
                 cohort: int, capacity: int, compact: bool,
                 tie_break: bool, metric_shape: Tuple[int, ...]):
        self.trainer, self.base_scores = trainer, base_scores
        self.aggregate, self.verify = aggregate, verify
        self.evaluate_all, self.layout = evaluate_all, layout
        self.states, self.data = states, data
        self.ver_x, self.ver_m = ver_x, ver_m
        self.priorities, self.max_threshold = priorities, max_threshold
        self.cohort_size, self.capacity = cohort, capacity
        self.compact = compact
        dev = states.params.device
        self.device = dev
        n = states.params.shape[0]
        i64 = torch.int64
        self.ids = torch.arange(n, device=dev)
        self.sel_all = torch.zeros((capacity, cohort), dtype=i64, device=dev)
        self.u_all = (torch.zeros((capacity, cohort, n), device=dev)
                      if tie_break else None)
        self.slot = torch.zeros((), dtype=i64, device=dev)
        self.agg_count = torch.zeros(n, dtype=torch.int32, device=dev)
        self.sel = torch.zeros(cohort, dtype=i64, device=dev)
        self.sel_mask = torch.zeros(n, device=dev)
        self.u = (torch.zeros((cohort, n), device=dev) if tie_break
                  else None)
        idx = (torch.zeros(cohort, dtype=i64, device=dev) if compact
               else torch.arange(n, device=dev))
        self.co = trainer.cohort(idx, states.params, data.train_xb,
                                 data.train_mb, data.valid_xb, data.valid_mb)
        self.out = OutLayout(n, metric_shape, trainer.epochs)
        self.out_stack = torch.zeros((capacity, self.out.width), device=dev)
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

    # ---- the three bodies (no host read in any of them) ---- #

    def _enter(self) -> None:
        d, st = self.data, self.states
        at = self.slot.view(1)  # a device index: no host read
        self.sel.copy_(self.sel_all.index_select(0, at)[0])
        self.sel_mask.zero_()
        self.sel_mask.index_fill_(0, self.sel, 1.0)
        if self.compact:
            self.co.idx.copy_(torch.sort(self.sel).values)
        if self.u is not None:
            self.u.copy_(self.u_all.index_select(0, at)[0])
        self.trainer.begin(self.co, st.params, st.opt_state, st.prev_global,
                           d.train_xb, d.train_mb, d.valid_xb, d.valid_mb)

    def _leave(self) -> None:
        d, st = self.data, self.states
        res = self.trainer.finish(self.co, st.params, st.opt_state,
                                  self.sel_mask)
        st.params.copy_(res.params)
        st.opt_state.copy_(res.opt_state)
        # the vote tensor: the first selected client's valid split
        voter0 = self.sel[:1]
        base = self.base_scores(st.params,
                                d.valid_x.index_select(0, voter0)[0],
                                d.valid_m.index_select(0, voter0)[0])
        aggregator, scores = elect_on_device(
            base, self.u, self.sel, self.sel_mask, self.agg_count,
            self.max_threshold)
        won = aggregator >= 0
        merged, weights = self.aggregate(
            st.params, self.sel_mask, d.dev_x,
            sel_idx=self.co.idx if self.compact else None)
        is_agg = self.ids == aggregator  # all false for -1
        outcome = self.verify(st, merged, self.ver_x, self.ver_m,
                              is_agg.to(torch.float32), d.client_mask)
        st.where_(won, outcome.states)
        self.agg_count += (is_agg & won).to(torch.int32)
        metrics = self.evaluate_all(self.layout.tree(st.params), d.test_x,
                                    d.test_m, d.test_y, d.train_xb,
                                    d.train_mb, priorities=self.priorities)
        row = self.out.pack(
            aggregator=aggregator, metrics=metrics, scores=scores,
            weights=torch.where(won, weights, 0.0), rejected=st.rejected,
            min_valid=res.min_valid, tracking=res.tracking)
        self.out_stack.index_copy_(0, self.slot.view(1), row[None])
        self.slot += 1

    # ---- the host side ---- #

    def _mark(self):
        """After an epoch: its flags on their way to the host."""
        if self.go_host is None:
            return None
        self.go_host.copy_(self.co.go, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return event

    def _go(self, event, e: int) -> bool:
        """Whether some client is active in epoch e + 1: one host read."""
        self.host_reads += 1
        if event is None:
            return bool(self.co.go[e])
        event.synchronize()
        return bool(self.go_host[e])

    def _epochs(self) -> None:
        marks = [None] * self.trainer.epochs
        self.epoch()
        marks[0] = self._mark()
        ran = 1
        for e in range(1, self.trainer.epochs):
            self.epoch()  # speculative until go[e - 1] is read
            marks[e] = self._mark()
            if not self._go(marks[e - 1], e - 1):
                break
            ran += 1
        self.epochs_run.append(ran)

    def dispatch(self, schedule: Sequence[Sequence[int]],
                 draws: Optional[torch.Tensor],
                 agg_count: Optional[np.ndarray]) -> Callable[[], list]:
        """Run len(schedule) rounds: upload the selections and draws (and
        the quota, unless None: then the device carries it from the last
        chunk), replay the bodies round by round and start one copy of the
        output stack to the host. Returns the harvest: a call that waits
        for that copy and returns the rounds' FusedRoundOuts."""
        k = len(schedule)
        if k > self.capacity or any(len(s) != self.cohort_size
                                    for s in schedule):
            raise ValueError(f"a chunk of {k} rounds of {self.cohort_size} "
                             f"clients each fits this round's buffers; got "
                             f"{[len(s) for s in schedule]}")
        cuda = self.device.type == "cuda"

        def up(dst: torch.Tensor, src: torch.Tensor) -> None:
            dst.copy_(src.pin_memory() if cuda else src, non_blocking=cuda)

        up(self.sel_all[:k], torch.tensor(schedule, dtype=torch.int64))
        if self.u_all is not None:
            up(self.u_all[:k], draws)
        if agg_count is not None:
            up(self.agg_count, torch.as_tensor(
                np.asarray(agg_count, dtype=np.int32)))
        self.slot.zero_()
        for _ in range(k):
            self.enter()
            self._epochs()
            self.leave()
        if cuda:
            host = torch.empty((k, self.out.width), pin_memory=True)
            host.copy_(self.out_stack[:k], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = self.out_stack[:k].clone(), None

        def harvest() -> list:
            if done is not None:
                done.synchronize()
            rows = host.numpy()
            return [self.out.unpack(rows[r]) for r in range(k)]

        return harvest

    def stats(self) -> dict:
        """The graphs' replays, nodes and capture seconds, the host's flag
        reads and the epochs each round ran."""
        return {"graphs": {b.name: b.stats() for b in
                           (self.enter, self.epoch, self.leave)},
                "host_reads": self.host_reads,
                "epochs_run": list(self.epochs_run)}
