"""FlywheelController: drift verdict -> incremental federated fine-tune
(port of fedmse_tpu/flywheel/controller.py).

The controller polls the serving front's `DriftMonitor` (already
debounced: drifted AND sustained `min_batches` updates per gateway); when a
gateway's recommendation also survives `quorum` consecutive polls, it runs
an incremental federated fine-tune and installs the result through the
atomic swap (flywheel/swap.py).

The fine-tune is the EXISTING federation, not a new trainer:

  * data: the per-gateway fresh-normal reservoirs (flywheel/buffer.py),
    stacked into an ordinary FederatedData;
  * engine: a fused `RoundEngine` (federation/rounds.py: the round's
    bodies as CUDA graphs on the card), a few rounds at full participation
    of the ELIGIBLE cohort, with the dev-set verification and the dense
    layout (`finetune_config`);
  * warm start: CLONES of the live serving params (the fused round updates
    its state tensors in place, so handing it the resident tensors would
    change what is served before the swap): params and prev_global at the
    incumbent weights, Adam moments and verifier history fresh, the state
    discipline of an elastic join applied fleet-wide;
  * roster honor: gateways outside the serving roster sit the fine-tune
    out and keep their rows through the swap; slots the roster recycled
    since the last fine-tune warm-start from the incumbent MEAN of the
    member fleet, never from the departed tenant's weights.

`FinetuneRunner` keeps one captured engine per data shape: the reservoirs
stack to the same shapes once they are full, so a later fine-tune copies
its data and warm states into the captured engine's buffers instead of
capturing a new round. Each fine-tune draws from its own streams,
`ExperimentRngs(run=90_000 + swaps so far)`, apart from any training run's.

Anti-thrash: the monitor's `cooldown_updates` is armed by the swap's
rebaseline (serving/drift.py), and the controller backs off
`cooldown_polls` on top.

Background fine-tune (`background=True`): `trigger` snapshots the buffered
data and hands the fine-tune to a one-worker executor; polls return at
once and serving keeps dispatching and harvesting on the caller's thread.
The worker captures its round's graphs in thread-local mode on its own
stream (ops/graphs.py), so the serving thread's copies and waits go on
during the capture. The finished payload installs on the poll that finds
it done, on the serving thread, exactly as the synchronous path installs.
While a fine-tune is pending no second trigger fires.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.federation.rounds import RoundEngine
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               fresh_states)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

logger = logging.getLogger(__name__)

# fine-tune streams never collide with a training run's (run seeds stride
# from 0): the run index lives in its own range, one per swap so far
FINETUNE_RUN_OFFSET = 90_000
# captured fine-tune engines kept, one per data shape, least recent out
MAX_CACHED_ENGINES = 4


def finetune_config(cfg, rounds: int, epochs: Optional[int] = None):
    """The fine-tune's config: `rounds` rounds of `epochs` (default the
    run's) at full participation of the selected cohort, verifying on the
    shared dev set (the buffered valid splits are thin, and the reference
    quirk's "last client's split" could be an ineligible gateway's empty
    one), on the dense layout (the reservoirs never reach tiered scale)."""
    return cfg.replace(num_rounds=rounds,
                       epochs=cfg.epochs if epochs is None else epochs,
                       num_participants=1.0, verification_method="dev",
                       state_layout="dense")


class FinetuneRunner:
    """Runs fine-tunes on `device`, one captured fused engine per data
    shape (module docstring). `cfg` is the fine-tune's config
    (finetune_config)."""

    def __init__(self, model, cfg, model_type: str, update_type: str,
                 n_real: int, device: torch.device, cluster=None):
        self.model, self.cfg = model, cfg
        self.model_type, self.update_type = model_type, update_type
        self.n_real, self.device = n_real, device
        self.cluster = cluster
        self.layout = ParamLayout.of(model)
        self._engines: "collections.OrderedDict[tuple, RoundEngine]" = \
            collections.OrderedDict()
        self.engines_built = 0

    def _engine(self, data: FederatedData, rngs: ExperimentRngs,
                states: ClientStates, assignment) -> Tuple[RoundEngine, bool]:
        key = (tuple((f.name, tuple(getattr(data, f.name).shape))
                     for f in dataclasses.fields(FederatedData)),
               None if assignment is None else assignment.tobytes())
        engine = self._engines.get(key)
        if engine is None:
            kw = {}
            if assignment is not None:
                kw = {"cluster": self.cluster,
                      "cluster_assignment": assignment}
            engine = RoundEngine(self.model, self.cfg, data,
                                 n_real=self.n_real, rngs=rngs,
                                 model_type=self.model_type,
                                 update_type=self.update_type,
                                 states=states, fused=True, **kw)
            self._engines[key] = engine
            while len(self._engines) > MAX_CACHED_ENGINES:
                self._engines.popitem(last=False)
            self.engines_built += 1
            return engine, False
        self._engines.move_to_end(key)
        # the captured round reads these very buffers: copy, never rebind
        for f in dataclasses.fields(FederatedData):
            getattr(engine.data, f.name).copy_(getattr(data, f.name))
        engine.rngs = rngs
        engine.host = HostState.create(self.n_real)
        engine.states = states  # copied into the round's buffers
        return engine, True

    def run(self, finetune, warm: torch.Tensor, rngs: ExperimentRngs,
            rounds: int, assignment=None):
        """`rounds` fused rounds on `finetune` (a FinetuneData) from the
        flat warm params [N, P] (a tensor this call may keep). Returns
        (fine-tuned params as a stacked f32 tree of new tensors, per-round
        summaries, whether a captured engine was reused)."""
        eligible = np.asarray(finetune.eligible, bool)
        selected = sorted(int(g) for g in np.flatnonzero(eligible))
        data = finetune.federated(self.device, self.model.compute_dtype)
        engine, reused = self._engine(
            data, rngs, fresh_states(warm.to(self.device)), assignment)
        metrics = []
        for r in range(rounds):
            result = engine.run_round_fused(r, selected=selected)
            metrics.append({
                "round": r,
                "aggregator": result.aggregator,
                "mean_min_valid": float(np.nanmean(
                    result.min_valid[eligible])),
            })
        new_params = self.layout.tree(engine.states.params.clone())
        return new_params, metrics, reused


class FlywheelController:
    """Watches the drift monitor; fine-tunes and swaps when it sustains."""

    def __init__(self, batcher, monitor, buffer, model, model_type: str,
                 update_type: str, cfg, dev_x, *, rounds: int = 3,
                 quorum: int = 2, cooldown_polls: int = 8,
                 min_rows: int = 16, valid_frac: float = 0.25,
                 epochs: Optional[int] = None, clear_on_swap: bool = True,
                 background: bool = False, cluster=None):
        self.batcher = batcher
        self.monitor = monitor
        self.buffer = buffer
        self.model = model
        self.model_type = model_type
        self.update_type = update_type
        self.cfg = cfg
        self.dev_x = np.asarray(dev_x, np.float32)
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        self.rounds = rounds
        self.quorum = quorum
        self.cooldown_polls = cooldown_polls
        self.min_rows = min_rows
        self.valid_frac = valid_frac
        self.epochs = epochs if epochs is not None else cfg.epochs
        # clear_on_swap drops the reservoirs once a fine-tune consumed
        # them, so each fine-tune trains on rows admitted since the last
        # swap and tracks a walking regime; False keeps the long memory
        # (the right call when drift is episodic)
        self.clear_on_swap = clear_on_swap
        self.background = background
        # a ClusterSpec scopes the fine-tune's merges per cluster under the
        # assignment the engine SERVES (the roster's cluster column), so
        # each gateway fine-tunes toward the model it serves under
        self.cluster = cluster
        engine = batcher.engine
        roster0 = getattr(engine, "roster", None)
        if self._clustered and (roster0 is None or roster0.cluster is None):
            raise ValueError(
                "a clustered flywheel needs the serving roster's cluster "
                "column (ServingRoster(cluster=...)): the fine-tune must "
                "merge under the SAME assignment the engine serves")
        self.runner = FinetuneRunner(
            model, finetune_config(cfg, rounds, self.epochs), model_type,
            update_type, buffer.num_gateways, engine.device, cluster)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending = None  # (future, finetune, flagged, t0)
        n = engine.num_gateways
        self._poll_streak = np.zeros(n, np.int64)
        self._cooldown = 0
        # slots whose roster generation advances past this were
        # re-tenanted since the last fine-tune: they warm-start from the
        # incumbent mean, not the previous tenant's weights
        self._gen_seen = (None if roster0 is None
                          else roster0.generation.copy())
        self.events: List[Dict] = []
        self.polls = 0

    @property
    def _clustered(self) -> bool:
        return self.cluster is not None and not self.cluster.is_null

    # ------------------------------- loop -------------------------------- #

    def poll(self) -> Optional[Dict]:
        """One control tick (between flushes, or on a timer): advances the
        quorum streaks and, if the trigger fires, fine-tunes and swaps
        (synchronously, or with background=True hands the fine-tune to the
        executor and installs its payload on a LATER poll). Returns the
        swap event, or None."""
        self.polls += 1
        rec = np.asarray(self.monitor.swap_recommended(), bool)
        self._poll_streak = np.where(rec, self._poll_streak + 1, 0)
        if self._pending is not None:
            # a fine-tune is in flight: nothing else fires, and the
            # cooldown starts once its swap installs
            return self._finish_pending(block=False)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        flagged = np.flatnonzero(self._poll_streak >= self.quorum)
        if not len(flagged):
            return None
        return self.trigger(flagged)

    @property
    def finetune_pending(self) -> bool:
        """True while a background fine-tune is in flight."""
        return self._pending is not None

    def wait(self, timeout_s: Optional[float] = None) -> Optional[Dict]:
        """Block until a background fine-tune completes and install its
        swap; None when nothing was pending. A timeout keeps it pending; a
        FAILED fine-tune clears the pending slot and re-raises."""
        if self._pending is None:
            return None
        # exception() blocks like result() but does not raise the worker's
        # failure; _finish_pending re-raises it after clearing the slot
        self._pending[0].exception(timeout=timeout_s)
        return self._finish_pending(block=True)

    def trigger(self, flagged) -> Optional[Dict]:
        """Fine-tune and swap for a sustained drift verdict on `flagged`.
        Returns the swap event; None if the buffers cannot support a
        fine-tune yet (the controller then backs off `cooldown_polls`), or
        with background=True, where the event comes from a later poll."""
        if self._pending is not None:
            logger.info("flywheel trigger suppressed: a background "
                        "fine-tune is already in flight")
            return None
        t0 = time.perf_counter()
        roster = getattr(self.batcher.engine, "roster", None)
        member = None if roster is None else roster.member
        finetune = self.buffer.build_finetune_data(
            self.cfg.batch_size, self.dev_x, valid_frac=self.valid_frac,
            min_rows=self.min_rows, member=member)
        flagged = np.asarray(flagged, np.int64)
        if not finetune.eligible.any() \
                or not finetune.eligible[flagged].any():
            logger.info(
                "flywheel trigger on gateways %s suppressed: no eligible "
                "buffer (>= %d fresh-normal rows needed); backing off %d "
                "polls", flagged.tolist(), self.min_rows,
                self.cooldown_polls)
            self._cooldown = self.cooldown_polls
            return None
        if self.background:
            # `finetune` is detached from the live reservoirs (rows_for
            # copies), so the worker trains on frozen data while the
            # intake keeps admitting
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="flywheel-finetune")
            fut = self._executor.submit(self._finetune, finetune)
            self._pending = (fut, finetune, flagged, t0)
            logger.info("flywheel fine-tune dispatched to the background "
                        "(gateways %s); serving continues", flagged.tolist())
            return None
        new_params, ft_metrics = self._finetune(finetune)
        return self._install(finetune, new_params, ft_metrics, flagged, t0)

    def _finish_pending(self, block: bool) -> Optional[Dict]:
        fut, finetune, flagged, t0 = self._pending
        if not block and not fut.done():
            return None
        self._pending = None
        new_params, ft_metrics = fut.result()  # re-raises a worker failure
        return self._install(finetune, new_params, ft_metrics, flagged, t0)

    def _install(self, finetune, new_params, ft_metrics, flagged,
                 t0: float) -> Dict:
        """Build and atomically install the swap payload of a finished
        fine-tune (the serving thread's half, both paths)."""
        from fedmse_tpu_torch.flywheel.swap import build_and_apply_swap
        roster = getattr(self.batcher.engine, "roster", None)
        event = build_and_apply_swap(
            self.batcher, self.model, finetune, new_params,
            extra_event={
                "trigger_gateways": np.asarray(flagged).tolist(),
                "finetune_rounds": self.rounds,
                "finetune_seconds": round(time.perf_counter() - t0, 4),
                "finetune_async": self.background,
                "finetune_metrics": ft_metrics,
                # captured engines so far: a fine-tune that built none
                # reused one (module docstring)
                "finetune_engines_built": self.runner.engines_built,
                "buffer": self.buffer.occupancy(),
                "cluster_k": (None if self.cluster is None
                              else self.cluster.k),
            })
        # the streaks restart (the monitor was rebaselined inside the swap
        # and arms its own cooldown), the controller backs off, and the
        # roster generations fine-tuned under become the new baseline
        self._poll_streak[:] = 0
        self._cooldown = self.cooldown_polls
        if self.clear_on_swap:
            self.buffer.clear()
        if roster is not None:
            self._gen_seen = roster.generation.copy()
        self.events.append(event)
        return event

    # ----------------------------- fine-tune ----------------------------- #

    def _warm_start(self) -> torch.Tensor:
        """The incumbent params as a NEW flat f32 tensor [N, P] (never a
        view of the served tensors), recycled slots reset to the incumbent
        mean of the member fleet (the elastic-join inheritance rule)."""
        engine = self.batcher.engine
        warm = self.runner.layout.flatten(engine.params).clone()
        roster = getattr(engine, "roster", None)
        if roster is None or self._gen_seen is None:
            return warm
        recycled = (roster.generation > self._gen_seen) & roster.member
        if not recycled.any():
            return warm
        logger.info("flywheel warm start: recycled slot(s) %s inherit the "
                    "incumbent mean", np.flatnonzero(recycled).tolist())
        member = torch.as_tensor(roster.member, device=warm.device)
        mean = warm[member].mean(dim=0)
        warm[torch.as_tensor(recycled, device=warm.device)] = mean
        return warm

    def _assignment(self):
        """The served cluster assignment a clustered fine-tune merges under,
        read again at each fine-tune (a roster swap may have dropped the
        column: then refuse rather than fit a fresh one)."""
        if not self._clustered:
            return None
        roster = getattr(self.batcher.engine, "roster", None)
        if roster is None or roster.cluster is None:
            raise ValueError(
                "clustered flywheel fine-tune: the serving roster no longer "
                "carries a cluster column; the fine-tune must merge under "
                "the SAME assignment the engine serves — install a "
                "ServingRoster(cluster=...) before the next trigger")
        return np.asarray(roster.cluster, np.int32)

    def _finetune(self, finetune):
        """A few fused federated rounds on the buffered data, warm-started
        from the live params. Returns (new params as a stacked f32 tree,
        per-round summaries)."""
        rngs = ExperimentRngs(
            run=FINETUNE_RUN_OFFSET + len(self.events),
            data_seed=self.cfg.data_seed,
            run_seed_stride=self.cfg.run_seed_stride)
        new_params, metrics, _ = self.runner.run(
            finetune, self._warm_start(), rngs, self.rounds,
            self._assignment())
        return new_params, metrics
