"""The random streams of one (model_type, update_type, run) combination
(port of fedmse_tpu/utils/seeding.py::ExperimentRngs).

  * `data_rng`   numpy Generator seeded with data_seed: device sampling,
                 row shuffles and dev-set sampling, run-independent;
  * `select_rng` python Random(data_seed + 7919 (run + 1)): the per-round
                 client selection;
  * `generator`  a CPU torch.Generator seeded with run * run_seed_stride
                 (987654321 for run 0): the real clients' model init and
                 vote tie-breaks (per voter call on the per-phase path;
                 `vote_draws` for a chunk of fused rounds).

The first two are the JAX package's streams exactly, so data splits and
client selections are the same draws there and here. The third replaces
the JAX key stream; its numbers differ from jax.random's by design.

The fault streams (chaos masks, the elastic membership timeline, attack
noise, the red team's coalition and poison noise) are domain-separated like the JAX package's `chaos_key` /
`elastic_key`: each is a pure function of (run seed, stream tag, the ids
of one draw), drawn through `stream_rng`, and none of them touches
`generator`, `select_rng` or `data_rng`. So turning a fault on leaves the
init, selection and tie-break draws bit-identical. A draw keyed on an
absolute round t and an absolute client i depends on nothing else, so
padding the client axis or chunking the schedule cannot change it.

Padding cannot change the init or the tie-breaks either: `generator`
draws them at the REAL width only (the real clients' init, then
`vote_draws(..., clients=n_real, width=n_pad)`), so a run padded to a
multiple of the ranks draws exactly what the unpadded run draws, and the
draws of an unpadded run are what they always were. The pad rows' init
comes from a keyed stream of its own (`init_pad_key`, one draw per
absolute pad client: models/autoencoder.init_pad_params), and a pad
column's tie-break uniform is 0.5, a factor of exactly 1 (a pad client
is never a candidate).

`make_run_rngs` gives the R runs of a combination their streams, each
exactly the sequential driver's run r (federation/batched.py).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

# stream tags: the JAX package's spellings of "CHAO", "ELAS" and "REDT",
# and "ATTA"
CHAOS_STREAM_TAG = 0x4348414F
ELASTIC_STREAM_TAG = 0x454C4153
ATTACK_STREAM_TAG = 0x41545441
REDTEAM_STREAM_TAG = 0x52454454
# "IPAD": the pad clients' init (ExperimentRngs.init_pad_key)
INIT_PAD_STREAM_TAG = 0x49504144

StreamKey = Tuple[int, int]  # (run seed, stream tag)


def stream_rng(key: StreamKey, *ids: int) -> np.random.Generator:
    """The numpy Generator of one draw of a fault stream: seeded from the
    stream key and the draw's ids only (e.g. a sub-stream, the absolute
    round and the absolute client). Callers keep the number of ids fixed
    within a stream."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(key[0]), int(key[1])] + [int(i) for i in ids])))


def pad_draws(draws: torch.Tensor, width: Optional[int] = None
              ) -> torch.Tensor:
    """Tie-break uniforms [..., n] padded on the last axis to `width` with
    0.5 (a jitter factor of exactly 1); `draws` itself when no wider."""
    n = draws.shape[-1]
    if width is None or width <= n:
        return draws
    return torch.nn.functional.pad(draws, (0, width - n), value=0.5)


@dataclasses.dataclass
class ExperimentRngs:
    run: int
    data_seed: int = 1234
    run_seed_stride: int = 10000

    def __post_init__(self):
        self.data_rng = np.random.default_rng(self.data_seed)
        self.select_rng = random.Random(self.data_seed + 7919 * (self.run + 1))
        self.generator = torch.Generator().manual_seed(self.run_seed)

    @property
    def run_seed(self) -> int:
        run_seed = self.run * self.run_seed_stride
        return run_seed if run_seed != 0 else 987654321

    def vote_draws(self, rounds: int, voters: int, clients: int,
                   width: Optional[int] = None) -> torch.Tensor:
        """The tie-break uniforms of a chunk of fused rounds, [rounds,
        voters, width] f32 on the CPU: [rounds, voters, clients] from
        `generator` in one draw (`clients` the REAL clients), the columns
        padded to `width` (default `clients`) with 0.5. Round r's voter i
        jitters the scores with [r, i]. The chunk keeps them, so a replay
        after a rewind uses the same draws."""
        return pad_draws(torch.rand((rounds, voters, clients),
                                    generator=self.generator), width)

    def init_pad_key(self) -> StreamKey:
        """The key of this run's pad-client init stream (state.
        init_client_states); calling it consumes nothing."""
        return (self.run_seed, INIT_PAD_STREAM_TAG)

    def chaos_key(self) -> StreamKey:
        """The key of this run's chaos stream (chaos/masks.py); calling it
        consumes nothing."""
        return (self.run_seed, CHAOS_STREAM_TAG)

    def elastic_key(self) -> StreamKey:
        """The key of this run's membership stream (federation/elastic.py);
        calling it consumes nothing."""
        return (self.run_seed, ELASTIC_STREAM_TAG)

    def attack_key(self) -> StreamKey:
        """The key of this run's attack-noise stream (federation/attack.py);
        calling it consumes nothing."""
        return (self.run_seed, ATTACK_STREAM_TAG)

    def redteam_key(self) -> StreamKey:
        """The key of this run's red-team stream (redteam/masks.py,
        redteam/adversary.py); calling it consumes nothing."""
        return (self.run_seed, REDTEAM_STREAM_TAG)

    def state_dict(self) -> dict:
        """The selection and torch streams' positions, JSON-able (a resumed
        run continues them; `data_rng` serves data preparation only)."""
        version, internal, gauss = self.select_rng.getstate()
        return {"select": [version, list(internal), gauss],
                "generator": bytes(
                    self.generator.get_state().numpy()).hex()}

    def load_state_dict(self, state: dict) -> None:
        version, internal, gauss = state["select"]
        self.select_rng.setstate((version, tuple(internal), gauss))
        self.generator.set_state(torch.from_numpy(np.frombuffer(
            bytes.fromhex(state["generator"]), dtype=np.uint8).copy()))


def make_run_rngs(runs: int, data_seed: int = 1234,
                  run_seed_stride: int = 10000) -> List[ExperimentRngs]:
    """One ExperimentRngs per run, as the sequential driver makes run r's
    (main.run_combination): the streams of a batched federation."""
    return [ExperimentRngs(run=r, data_seed=data_seed,
                           run_seed_stride=run_seed_stride)
            for r in range(runs)]
