"""The general driver of the federated training cells: the input
generator, the program's set-up, the measured window, and the program's
side of the comparison.

Inputs (all from --seed, on the device, in a few large calls):

* the federation of `gateways` gateways in the layout
  `fedmse_tpu_torch.data.stacking.stack_clients` produces, with the
  distributions of `synthetic_clients`: each gateway's `normal_rows`
  normal rows N(0, 1) and `abnormal_rows` abnormal rows N(4, 2) over the
  configuration's features, the normal rows split 40/10/40/10 into train,
  validation, dev and test, standardized by the gateway's own train
  statistics; the test set is the normal test rows then the abnormal
  rows. The shared dev set is `dev_rows_per_gateway` rows drawn without
  replacement from each gateway's dev split (null: all of them, the
  reference's rule at equal splits), standardized by its own statistics;
* each gateway's initial parameters, U(+-1/sqrt(fan_in)) weights and zero
  biases, one flat f32 row in the published layout.

The program: `fedmse_tpu_torch.federation.rounds.RoundEngine` with the
fused round (CUDA graphs on the card), driven as `main.run_combination`
drives it, by `federation.pipeline.run_pipelined_schedule` in chunks of
`fused_schedule_chunk`, pipelined, `can_rewind=False`. Set-up runs the
first rounds through that same call in chunks of SETUP_CHUNKS (the first
call captures the round's graphs) and then one chunk of EVAL_CHUNK, and
keeps their outputs, the states after each chunk and, after each chunk
but the first, the test rows' anomaly scores that the last round's
evaluation produced, for the comparison. The window then calls it once
with a deadline in place of the round count: chunks are dispatched while
the host clock is before the deadline, and the window closes at the
harvest of the last one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference.fedmse import Reference, leaf_shapes

# the set-up rounds, in chunks: the reference follows them
SETUP_CHUNKS = (1, 2)
# one more set-up chunk, long enough to reach position 3 of the window's
# chunks: its last round's scores are judged, not its trajectory
EVAL_CHUNK = 4
# the sizes a rehearsal on the CPU runs these cells at (benchmark/tests)
TINY = {"config": {"dim_features": 16, "hidden_neus": 8, "latent_dim": 3,
                   "knn_bank_size": 64},
        "traffic": {"gateways": 6, "normal_rows": 300, "abnormal_rows": 60,
                    "dev_rows_per_gateway": 20}}


class Deadline:
    """A round count for `run_pipelined_schedule` that lasts until a time:
    the loop's `round_index < num_rounds` holds while the host clock is
    before `deadline`, and `num_rounds - round_index` is a whole chunk.
    It counts the checks that held and when the last one was made, so
    that `check` can tell whether the loop used it that way."""

    def __init__(self, deadline: float, chunk: int):
        self.deadline, self.chunk = deadline, chunk
        self.held, self.last_held, self.ended = 0, None, None

    def __gt__(self, round_index: int) -> bool:
        now = time.perf_counter()
        if now < self.deadline:
            self.held, self.last_held = self.held + 1, now
            return True
        self.ended = now
        return False

    def __sub__(self, round_index: int) -> int:
        return self.chunk

    def check(self, rounds: int, chunks: int) -> None:
        """Raise unless the window dispatched whole chunks, one for each
        check that held, the last before the deadline, and ended on a
        check at or after it."""
        if not (self.held == chunks and rounds == chunks * self.chunk
                and (self.last_held is None
                     or self.last_held < self.deadline)
                and self.ended is not None
                and self.ended >= self.deadline):
            raise RuntimeError(
                f"the window's loop did not run whole chunks of "
                f"{self.chunk} until the deadline: {chunks} chunks, "
                f"{rounds} rounds, {self.held} checks held; "
                "run_pipelined_schedule no longer reads the round count "
                "as this driver expects")


def split_sizes(n: int):
    train, valid, dev = int(0.4 * n), int(0.1 * n), int(0.4 * n)
    return train, valid, dev, n - train - valid - dev


def _standardize(x: torch.Tensor, fit: torch.Tensor) -> torch.Tensor:
    """x by the column mean and std (ddof 0; a zero std taken as 1) of the
    rows `fit` [..., R, D]."""
    mean = fit.mean(dim=-2, keepdim=True)
    std = fit.std(dim=-2, unbiased=False, keepdim=True)
    return (x - mean) / torch.where(std == 0, torch.ones_like(std), std)


def _batches(x: torch.Tensor, batch: int):
    """[N, R, D] -> ([N, NB, B, D] zero-padded, [N, NB, B] row mask)."""
    n, rows, d = x.shape
    nb = -(-rows // batch)
    pad = nb * batch - rows
    xb = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(n, nb, batch, d)
    mask = (torch.arange(nb * batch, device=x.device) < rows).float()
    return xb, mask.view(1, nb, batch).expand(n, nb, batch).contiguous()


def make_federation(traffic: Dict, cfg: Dict, seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The federation's tensors by FederatedData's field names."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n, dim = traffic["gateways"], cfg["dim_features"]
    rows, ab = traffic["normal_rows"], traffic["abnormal_rows"]
    n_train, n_valid, n_dev, n_test = split_sizes(rows)
    normal = torch.randn((n, rows, dim), generator=g, device=device)
    abnormal = torch.randn((n, ab, dim), generator=g, device=device) \
        * 2.0 + 4.0
    train = normal[:, :n_train]
    cut = [n_train, n_train + n_valid, n_train + n_valid + n_dev]
    valid = _standardize(normal[:, cut[0]:cut[1]], train)
    dev_raw = normal[:, cut[1]:cut[2]]
    test = torch.cat([_standardize(normal[:, cut[2]:], train),
                      _standardize(abnormal, train)], dim=1)
    per = traffic.get("dev_rows_per_gateway") or n_dev
    pick = torch.rand((n, n_dev), generator=g, device=device).argsort(
        dim=1)[:, :per]
    pool = torch.gather(dev_raw, 1, pick[:, :, None].expand(n, per, dim))
    pool = pool.reshape(1, n * per, dim)
    dev_x = _standardize(pool, pool)[0]
    train = _standardize(train, train)
    batch = cfg["batch_size"]
    train_xb, train_mb = _batches(train, batch)
    valid_xb, valid_mb = _batches(valid, batch)
    labels = torch.cat([torch.zeros(n_test), torch.ones(ab)]).to(device)
    data = {"train_xb": train_xb, "train_mb": train_mb,
            "valid_xb": valid_xb, "valid_mb": valid_mb,
            "valid_x": valid.contiguous(),
            "valid_m": torch.ones((n, n_valid), device=device),
            "test_x": test.contiguous(),
            "test_m": torch.ones((n, n_test + ab), device=device),
            "test_y": labels.expand(n, -1).contiguous(),
            "dev_x": dev_x.contiguous(),
            "client_mask": torch.ones(n, device=device)}
    return data


def init_params(n: int, dims, seed: int, device: torch.device
                ) -> torch.Tensor:
    """[N, P] f32: U(+-1/sqrt(fan_in)) weights, zero biases, one call."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    bounds = []
    for shape in leaf_shapes(dims):
        size = int(np.prod(shape))
        bounds.append(torch.full((size,), 1.0 / math.sqrt(shape[0])
                                 if len(shape) == 2 else 0.0))
    bound = torch.cat(bounds).to(device)
    u = torch.rand((n, bound.shape[0]), generator=g, device=device)
    return (u * 2.0 - 1.0) * bound


def shapes_of(traffic: Dict, cfg: Dict) -> Dict[str, int]:
    """The cell's shapes, from the configuration and the traffic."""
    n = traffic["gateways"]
    n_train, n_valid, n_dev, n_test = split_sizes(traffic["normal_rows"])
    per = traffic.get("dev_rows_per_gateway") or n_dev
    batch = cfg["batch_size"]
    return {"gateways": n,
            "cohort": max(1, int(cfg["num_participants"] * n)),
            "epochs": cfg["epochs"], "batch": batch,
            "train_rows": n_train, "valid_rows": n_valid,
            "train_rows_padded": -(-n_train // batch) * batch,
            "test_rows": n_test + traffic["abnormal_rows"],
            "dev_rows": n * per,
            "bank": 1 << (cfg["knn_bank_size"] - 1).bit_length()}


def _program_round(result) -> Dict:
    """A RoundResult in the comparison's terms."""
    n = len(result.client_metrics)
    rejected = np.full(n, -1, np.int64)
    for row in result.verification_results:
        rejected[row["client_id"]] = row["rejected_updates"]
    zeros = np.zeros(n, np.float32)
    return {"aggregator": -1 if result.aggregator is None
            else int(result.aggregator),
            "scores": zeros if result.mse_scores is None
            else np.asarray(result.mse_scores)[:n],
            "weights": zeros if result.agg_weights is None
            else np.asarray(result.agg_weights)[:n],
            "rejected": rejected,
            "metrics": np.asarray(result.client_metrics),
            "tracking": np.asarray(result.tracking)}


@contextlib.contextmanager
def kept_scores():
    """Keep a handle on the anomaly scores [N, T] that the fused round's
    evaluation hands to `roc_auc`. The handle adds no operation: on the
    card it is the captured graph's own tensor, which each replay of the
    round rewrites, so after a replayed round it holds that round's
    scores. (The round that captures the graph computes eagerly first and
    leaves the captured tensor unwritten: read none after it.)"""
    from fedmse_tpu_torch.evaluation import evaluator
    real, held = evaluator.roc_auc, {}

    def keep(labels, scores, mask, *a, **kw):
        held["scores"] = scores
        return real(labels, scores, mask, *a, **kw)

    evaluator.roc_auc = keep
    try:
        yield held
    finally:
        evaluator.roc_auc = real


def _snapshot(states) -> Dict[str, np.ndarray]:
    return {"params": states.params.detach().cpu().numpy().copy(),
            "mu": states.opt_state.mu.detach().cpu().numpy().copy()}


@dataclasses.dataclass
class Federation:
    """The program under test and what set-up kept of it."""

    config: Dict
    traffic: Dict
    seed: int
    data: Dict[str, torch.Tensor]
    params0: torch.Tensor
    engine: object = None
    rounds_done: int = 0
    setup_record: Optional[Dict] = None


def experiment_config(config: Dict):
    from fedmse_tpu_torch.config import ExperimentConfig
    return ExperimentConfig.from_json(config)


def inputs(config: Dict, traffic: Dict, seed: int,
           device: torch.device) -> Federation:
    """The benchmark's inputs from the seed, with no program built."""
    dims = (config["dim_features"], config["hidden_neus"],
            config["latent_dim"])
    return Federation(config, traffic, seed,
                      make_federation(traffic, config, seed, device),
                      init_params(traffic["gateways"], dims, seed, device))


def setup(config: Dict, traffic: Dict, seed: int,
          device: torch.device) -> Federation:
    """Inputs, the engine, and the set-up rounds (which capture the
    graphs) through the window's own call."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
    from fedmse_tpu_torch.federation.rounds import RoundEngine
    from fedmse_tpu_torch.federation.state import fresh_states
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    fed = inputs(config, traffic, seed, device)
    data, params0 = fed.data, fed.params0
    dims = (config["dim_features"], config["hidden_neus"],
            config["latent_dim"])
    cfg = experiment_config(config)
    model = make_model(config["model_type"], *dims, cfg.shrink_lambda,
                       precision=cfg.precision, device=device)
    rngs = ExperimentRngs(run=1, data_seed=int(seed),
                          run_seed_stride=int(seed))
    engine = RoundEngine(model, cfg, FederatedData(**data),
                         n_real=traffic["gateways"], rngs=rngs,
                         model_type=config["model_type"],
                         update_type=config["update_type"],
                         states=fresh_states(params0.clone()), fused=True)
    fed.engine = engine
    rounds, states, evals = [], [], []

    def consume(results, sec):
        rounds.extend(_program_round(r) for r in results)
        return None

    with kept_scores() as held:
        for i, k in enumerate(SETUP_CHUNKS + (EVAL_CHUNK,)):
            run_pipelined_schedule(engine, fed.rounds_done,
                                   fed.rounds_done + k,
                                   cfg.fused_schedule_chunk, consume,
                                   can_rewind=False, pipelined=True)
            fed.rounds_done += k
            states.append(_snapshot(engine.states))
            if i > 0:
                evals.append({"params": states[-1]["params"],
                              "scores": held["scores"].detach().cpu()
                              .numpy().copy(), "position": k - 1})
        held.clear()
    fed.setup_record = {"params0": params0.cpu().numpy().copy(),
                        "rounds": rounds[:sum(SETUP_CHUNKS)],
                        "states": states[:len(SETUP_CHUNKS)],
                        "evals": evals}
    return fed


def bodies(engine):
    f = engine._fused
    return (f.enter, f.epoch, f.leave)


def capture_count() -> int:
    from fedmse_tpu_torch.ops.graphs import WRAPPERS
    return sum(w.captured for w in WRAPPERS.values())


def window(fed: Federation, seconds: float) -> Dict:
    """The measured window: run_pipelined_schedule until the deadline.
    Returns the window's opening time and seconds, its rounds and the
    epochs they ran, failures (rounds with no finite AUC), the seconds
    between one chunk's harvest and the next's (the first from the
    opening), the pipeline's summary and the host's seconds in graph
    replays."""
    from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
    engine = fed.engine
    chunk = engine.cfg.fused_schedule_chunk
    fused, captured = engine._fused, capture_count()
    replay0 = sum(b.replay_seconds for b in bodies(engine))
    epochs0 = len(fused.epochs_run)
    seen = {"rounds": 0, "failed": 0}
    harvests = []

    def consume(results, sec):
        harvests.append(time.perf_counter())
        for r in results:
            seen["rounds"] += 1
            if not np.isfinite(np.asarray(r.client_metrics)).any():
                seen["failed"] += 1
        return None

    t_open = time.perf_counter()
    deadline = Deadline(t_open + seconds, chunk)
    stats = run_pipelined_schedule(
        engine, fed.rounds_done, deadline, chunk,
        consume, can_rewind=False, pipelined=True)
    t_close = time.perf_counter()
    if engine._fused is not fused or capture_count() != captured:
        raise RuntimeError("a graph was captured inside the window: set-up "
                           "did not warm every shape the window uses")
    deadline.check(seen["rounds"], stats.chunks)
    fed.rounds_done += seen["rounds"]
    return {"t_open": t_open, "window_s": t_close - t_open,
            "rounds": seen["rounds"],
            "epochs": sum(fused.epochs_run[epochs0:]),
            "failed": seen["failed"],
            "chunk_s": np.diff([t_open] + harvests).tolist(),
            "pipeline": stats.summary(),
            "graph_replay_s": sum(b.replay_seconds for b in bodies(engine))
            - replay0}


def traced_chunk(fed: Federation, tracer) -> None:
    """One more chunk through the window's own call, after the window,
    with the round's bodies traced (benchmark/trace.RoundTracer)."""
    from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
    engine = fed.engine
    chunk = engine.cfg.fused_schedule_chunk
    tracer.attach(engine._fused)
    try:
        run_pipelined_schedule(engine, fed.rounds_done,
                               fed.rounds_done + chunk, chunk,
                               lambda results, sec: None, can_rewind=False,
                               pipelined=True)
    finally:
        tracer.detach(engine._fused)
    fed.rounds_done += chunk


def end_to_end(out: Dict) -> Dict[str, float]:
    return {"round_ms": 1e3 * out["window_s"] / out["rounds"]}


def reference_record(fed: Federation, judged: Optional[Dict] = None,
                     tf32: bool = False) -> Dict:
    """The reference's rounds over SETUP_CHUNKS, from the benchmark's
    inputs (never the program's state), and its scores of the test rows
    under each parameter state that `judged` (the record being judged)
    kept in its "evals": the one place where the reference reads what the
    program made, to judge the scores the program made from it. With
    `tf32` (the control in the program's place) it keeps its own "evals"
    as the program does, after each chunk but the first."""
    ref = Reference(fed.config, fed.data, fed.params0, fed.seed, tf32=tf32)
    out = ref.run(SETUP_CHUNKS, evals=tf32)
    out["params0"] = fed.params0.cpu().numpy().copy()
    if judged is not None:
        out["evals"] = [{"scores": ref.scores(torch.as_tensor(e["params"]))
                         .cpu().numpy()} for e in judged["evals"]]
    return out


def free_program(fed: Federation) -> None:
    """Drop the program: its graphs live in reference cycles, so collect
    them before the card's cache is emptied."""
    import gc
    fed.engine = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def flops_per_round(fed_config: Dict, traffic: Dict) -> float:
    dims = (fed_config["dim_features"], fed_config["hidden_neus"],
            fed_config["latent_dim"])
    parts = roofline.round_flops(shapes_of(traffic, fed_config), dims,
                                 fed_config["score_kind"],
                                 fed_config["update_type"])
    return sum(parts.values())
